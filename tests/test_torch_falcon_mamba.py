"""The port's falcon-mamba (mamba1 stack) against the reference's.

Smoke falcon-mamba-7b in fp32 (2 mamba1 layers, d 64, d_inner 128, state
8, dt_rank 4, conv 4, vocab 256, tied embeddings), the reference's
``init_params`` carried across by ``repro_torch.models.convert``.  The
reference runs its chunked scan with chunks of 16 tokens here, so a
40-token prompt crosses two chunk boundaries; the port runs the
selective-scan wrapper (its plain version on the CPU).

Tolerances: rtol = atol = 5e-4 on whole-prompt logits, as the reference's
own ``tests/test_models_smoke.py`` holds its decode to its forward; atol
1e-4 on the state and on decode logits (fp32, summation order through 2
layers and a 256-way head); greedy tokens identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.distributed import serve as ref_serve  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.layers import rmsnorm as ref_rmsnorm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import serve  # noqa: E402
from repro_torch.kernels.selective_scan import ops as ss_ops  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference, reference_tree  # noqa: E402
from repro_torch.serving import make_workload  # noqa: E402

ARCH = "falcon-mamba-7b"
ATOL = 1e-4
MAX_LEN, MAX_PROMPT = 64, 40


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_smoke_config(ARCH)
    rcfg = dataclasses.replace(ref_registry.get_smoke_config(ARCH), ssm_chunk=16)
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    mesh = compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))
    return cfg, rcfg, params, rparams, mesh


def _prompt(seed, shape, cfg):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_smoke_and_full_configs_are_the_references(setup):
    cfg, _, params, _, _ = setup
    for name, ours, theirs in (("smoke", cfg, ref_registry.get_smoke_config(ARCH)),
                               ("full", registry.get_config(ARCH), ref_registry.get_config(ARCH))):
        ours_d, theirs_d = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert ours_d == {k: v for k, v in theirs_d.items() if k in ours_d}, name
        assert (ours.d_inner, ours.dt_rank) == (theirs.d_inner, theirs.dt_rank), name
        assert ours.n_params() == theirs.n_params(), name
    assert registry.get_config(ARCH).n_params() == 7_005_802_496
    fresh = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in fresh["layers"].items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in params["layers"].items()}
    # the reference's analytic count leaves out each layer's dt_bias [di]
    counted = sum(v.numel() for v in jax.tree.leaves(reference_tree(fresh)))
    assert counted == sum(np.size(v) for v in jax.tree.leaves(setup[3]))
    assert counted == cfg.n_params() + cfg.n_layers * cfg.d_inner
    # log(1..N) on both sides (the two libraries' logs may differ by an ulp)
    torch.testing.assert_close(fresh["layers"]["A_log"], params["layers"]["A_log"],
                               rtol=1e-6, atol=0)


def test_other_ssm_versions_and_families_are_refused():
    full = registry.get_config(ARCH)
    with pytest.raises(ValueError, match="mamba2 is not ported"):
        registry.override(full, ssm_version=2)
    with pytest.raises(ValueError, match="hybrid family is mamba2"):
        registry.override(full, family="hybrid")  # the hybrid family is ported, mamba2 only
    with pytest.raises(ValueError, match="unknown family"):  # audio is ported now
        registry.override(full, family="encoder")
    with pytest.raises(ValueError, match="ssm_state > 0"):
        registry.override(full, ssm_state=0)


def test_a_log_and_d_stay_fp32_from_a_bf16_tree():
    """The reference keeps A_log and D in fp32 whatever the param dtype;
    the conversion must not round them to bf16 (A = -exp(A_log) would move)."""
    rcfg = dataclasses.replace(ref_registry.get_smoke_config(ARCH), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    cfg = registry.override(registry.get_smoke_config(ARCH), param_dtype="bfloat16",
                            compute_dtype="bfloat16")
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(1))
    assert rparams["layers"]["mamba"]["A_log"].dtype == jnp.float32
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    for k, leaf in params["layers"].items():
        assert leaf.dtype == (torch.float32 if k in ("A_log", "D") else torch.bfloat16), k
    np.testing.assert_array_equal(params["layers"]["A_log"].numpy(),
                                  np.asarray(rparams["layers"]["mamba"]["A_log"]))
    fresh = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert fresh["layers"]["A_log"].dtype == fresh["layers"]["D"].dtype == torch.float32


def _layer(params, rparams, i):
    lp = {k: v[i] for k, v in params["layers"].items()}
    rlp = jax.tree.map(lambda a: a[i], rparams["layers"])
    return lp, rlp


def test_conv_helpers_match_reference():
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 9, 16), (4, 16), (16,)))
    np.testing.assert_allclose(ssm.causal_conv1d(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(ref_ssm.causal_conv1d(x, w, b)), atol=1e-6)
    state = rng.standard_normal((2, 3, 16)).astype(np.float32)
    ours, ost = ssm.conv1d_step(_t(x[:, 0]), _t(state), _t(w), _t(b))
    theirs, tst = ref_ssm.conv1d_step(x[:, 0], state, w, b)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)
    np.testing.assert_array_equal(ost.numpy(), np.asarray(tst))


@pytest.mark.parametrize("S", [1, 3, 40])
def test_mamba1_block_and_final_state_match_reference(setup, S):
    """One layer over S tokens: the output, and the state it leaves equals
    the reference's decode step scanned over the same inputs."""
    cfg, rcfg, params, rparams, _ = setup
    lp, rlp = _layer(params, rparams, 1)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ours, state = ssm.mamba1_apply(lp, _t(x), cfg)
    theirs = ref_ssm.mamba1_apply(rlp["mamba"], jnp.asarray(x), rcfg, chunk=16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL, rtol=0)
    rstate = ref_ssm.mamba1_init_state(rcfg, 2, jnp.float32)
    for t in range(S):
        ry, rstate = ref_ssm.mamba1_decode(rlp["mamba"], jnp.asarray(x[:, t]), rstate, rcfg)
    np.testing.assert_allclose(ours[:, -1].numpy(), np.asarray(ry), atol=ATOL, rtol=0)
    for n in ("h", "conv"):
        assert tuple(state[n].shape) == rstate[n].shape
        np.testing.assert_allclose(state[n].numpy(), np.asarray(rstate[n]), atol=ATOL, rtol=0)


def test_mamba1_decode_matches_reference(setup):
    cfg, rcfg, params, rparams, _ = setup
    lp, rlp = _layer(params, rparams, 0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    h = (rng.standard_normal((3, cfg.d_inner, cfg.ssm_state)) * 0.3).astype(np.float32)
    conv = rng.standard_normal((3, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32)
    theirs, rnew = ref_ssm.mamba1_decode(rlp["mamba"], jnp.asarray(x),
                                         {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}, rcfg)
    # the port updates the state in place; with write_ok, row 1 keeps its own
    for write_ok in (None, torch.tensor([True, False, True])):
        state = {"h": _t(h).clone(), "conv": _t(conv).clone()}
        ours = ssm.mamba1_decode(lp, _t(x), state, cfg, write_ok)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL, rtol=0)
        for n, old in (("h", h), ("conv", conv)):
            want = np.asarray(rnew[n]).copy()
            if write_ok is not None:
                want[1] = old[1]
            np.testing.assert_allclose(state[n].numpy(), want, atol=ATOL, rtol=0)


def test_last_logits_match_reference_full_sequence(setup):
    """The port's whole-prompt forward (and ``make_prefill_step``) against
    the reference's full-sequence logits at the last position, a 40-token
    prompt (three of the reference's 16-token chunks)."""
    cfg, rcfg, params, rparams, mesh = setup
    tokens = _prompt(0, (2, 40), cfg)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.zeros((2, 40), jnp.int32)}
    x, _ = ref_tf._embed_inputs(rparams, batch, rcfg)
    h, _ = ref_tf._run_stack(rparams, x, rcfg, jnp.arange(40)[None, :])
    full = np.asarray(ref_tf._logits(rparams, ref_rmsnorm(h, rparams["final_norm"],
                                                          rcfg.norm_eps), rcfg))
    n0 = ss_ops.selective_scan.launches
    ours = transformer.forward_last_logits(params, torch.from_numpy(tokens).long(), cfg)
    step = serve.make_prefill_step(cfg, device="cpu")(params, {"tokens": torch.from_numpy(tokens)})
    rstep, _ = ref_serve.make_prefill_step(rcfg, mesh)
    theirs = jax.jit(rstep)(rparams, {"tokens": jnp.asarray(tokens)})
    assert ss_ops.selective_scan.launches == n0  # the CPU runs the plain version
    for got in (ours, step):
        assert got.shape == (2, cfg.vocab) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), full[:, -1], rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs), rtol=5e-4, atol=5e-4)


def _reference_scan_prefill(rcfg, rparams, mesh, prompt, slots, slot):
    rprefill, _ = ref_serve.make_slot_prefill_step(rcfg, mesh, MAX_PROMPT)
    padded = np.zeros(MAX_PROMPT, np.int32)
    padded[:prompt.shape[0]] = prompt
    cache = ref_tf.init_cache(rcfg, slots, MAX_LEN)
    return jax.jit(rprefill)(rparams, jnp.asarray(padded), jnp.int32(prompt.shape[0]), cache,
                             jnp.int32(slot))


@pytest.mark.parametrize("plen", [1, 2, 3, 17, 40])
def test_one_forward_prefill_state_matches_reference_scan(setup, plen):
    """The port admits a prompt with one forward (one scan a layer); the
    reference scans its decode step over the padded prompt.  Same last
    logits and the same state in the slot (the conv state zero-padded in
    front below K - 1 = 3 tokens); the slot was dirty before, the other
    slots are untouched."""
    cfg, rcfg, params, rparams, mesh = setup
    prompt = _prompt(plen, (plen,), cfg)
    rlast, rcache = _reference_scan_prefill(rcfg, rparams, mesh, prompt, slots=3, slot=1)
    cache = transformer.init_cache(cfg, 3, MAX_LEN, device="cpu")
    for leaf in cache.values():
        leaf.normal_()  # a previous request's state must not survive
    before = {n: leaf.clone() for n, leaf in cache.items()}
    last = serve.make_slot_prefill_step(cfg, MAX_PROMPT)(
        params, torch.from_numpy(prompt).long(), cache, 1)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), atol=ATOL, rtol=0)
    assert set(cache) == set(rcache) == {"h", "conv"}
    assert cache["h"].dtype == torch.float32 and cache["conv"].dtype == torch.float32
    for n, leaf in cache.items():
        ax = serve.CACHE_BATCH_AXIS[n]
        assert tuple(leaf.shape) == rcache[n].shape
        np.testing.assert_allclose(leaf.select(ax, 1).numpy(),
                                   np.take(np.asarray(rcache[n]), 1, axis=ax), atol=ATOL, rtol=0)
        for other in (0, 2):
            assert torch.equal(leaf.select(ax, other), before[n].select(ax, other))


def test_greedy_decode_matches_reference(setup):
    """A 12-token prompt, then 24 greedy decode steps: logits each step and
    tokens identical, and the final state."""
    cfg, rcfg, params, rparams, _ = setup
    prompts = _prompt(3, (2, 12), cfg)
    rstep = jax.jit(lambda p, t, c, n: ref_tf.forward_decode(p, t, c, n, rcfg))
    rcache = ref_tf.init_cache(rcfg, 2, MAX_LEN)
    for i in range(12):
        rlogits, rcache = rstep(rparams, jnp.asarray(prompts[:, i]), rcache, jnp.int32(i))
    cache = transformer.init_cache(cfg, 2, MAX_LEN, device="cpu")
    prefill = serve.make_slot_prefill_step(cfg, MAX_PROMPT)
    logits = torch.stack([prefill(params, torch.from_numpy(prompts[b]).long(), cache, b)
                          for b in range(2)])
    step = serve.make_pool_decode_step(cfg)
    active = torch.ones(2, dtype=torch.bool)
    for i in range(12, 36):
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), atol=ATOL, rtol=0)
        tok = np.asarray(jnp.argmax(rlogits, -1)).astype(np.int32)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), tok)
        rlogits, rcache = rstep(rparams, jnp.asarray(tok), rcache, jnp.int32(i))
        logits = step(params, torch.from_numpy(tok).long(), cache, torch.full((2,), i), active)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), atol=ATOL, rtol=0)
    for n, leaf in cache.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(rcache[n]), atol=ATOL, rtol=0)


def test_inactive_slots_keep_their_state(setup):
    """``active`` False: the slot's h and conv stay as they were (the
    reference's select_slots); the active slots' state moves."""
    cfg, _, params, _, _ = setup
    cache = transformer.init_cache(cfg, 3, MAX_LEN, device="cpu")
    for leaf in cache.values():
        leaf.normal_()
    before = {n: leaf.clone() for n, leaf in cache.items()}
    active = torch.tensor([True, False, True])
    serve.make_pool_decode_step(cfg)(params, torch.tensor([1, 2, 3]), cache,
                                     torch.tensor([5, 20, 40]), active)
    for n, leaf in cache.items():
        ax = serve.CACHE_BATCH_AXIS[n]
        assert torch.equal(leaf.select(ax, 1), before[n].select(ax, 1))
        for s in (0, 2):
            assert not torch.equal(leaf.select(ax, s), before[n].select(ax, s))


def test_ssm_is_not_pageable():
    """``llm_decode_paged`` refuses the mamba1 family, in the port as in the
    reference, with the reference's message."""
    cfg, rcfg = registry.get_smoke_config(ARCH), ref_registry.get_smoke_config(ARCH)
    with pytest.raises(ValueError) as theirs:
        ref_serve.validate_pageable(rcfg, MAX_LEN)
    with pytest.raises(ValueError) as ours:
        serve.validate_pageable(cfg, MAX_LEN)
    assert str(ours.value) == str(theirs.value)
    assert "use the contiguous pool" in str(ours.value)
    with pytest.raises(ValueError, match="no pageable KV cache"):
        make_workload("llm_decode_paged", cfg=cfg, slots=2, max_len=MAX_LEN,
                      max_prompt_len=MAX_PROMPT, device="cpu", block_size=8)


def test_training_the_ssm_family_is_refused(setup):
    """No longer refused: the mamba1 stack trains through the chunked scan
    (``ssm.chunk_scan``, the kernel has no backward); one step builds and
    runs with finite values (its parity: ``test_torch_train_families.py``)."""
    from repro_torch.distributed import step as step_lib

    step = step_lib.make_train_step(setup[0], step_lib.TrainConfig(), dp=1, device="cpu")
    state = step.init_state(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 5), dtype=torch.long)
    _, m = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


def test_ssm_forward_refuses_remat(setup):
    """Remat is no longer refused for the ssm stack: under autograd the
    mamba1 layer runs the chunked scan, so ``"full"`` and ``"dots"``
    recompute it and give the loss of ``"none"`` (fp32, within 1e-6)."""
    cfg, params = setup[0], setup[2]
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "labels": torch.zeros((1, 4), dtype=torch.long)}
    losses = [float(transformer.forward_train(params, batch, cfg, r)[0])
              for r in ("none", "full", "dots")]
    assert max(losses) - min(losses) <= 1e-6, losses
