"""The port's gemma3 (grouped local/global stack) against the reference's.

Smoke gemma3-12b in fp32 (3 layers: 2 local with a 16-token window and
RoPE theta 1e4, 1 global with theta 1e6; d 64, 4 heads, 2 KV heads, hd
16), the reference's ``init_params`` carried across by
``repro_torch.models.convert``.  Prompts are longer than the window and
decoding runs past it, so the rolling local caches wrap.

Tolerance: atol 1e-4 on fp32 logits and cache rows (the two sides sum in
different orders through 3 layers and a 256-way head); greedy tokens must
be identical.
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
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference, reference_tree  # noqa: E402
from repro_torch.serving import make_workload  # noqa: E402

ATOL = 1e-4
ARCH = "gemma3-12b"
MAX_LEN, MAX_PROMPT = 48, 32


@pytest.fixture(scope="module")
def setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, rcfg = registry.get_smoke_config(ARCH), ref_registry.get_smoke_config(ARCH)
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    mesh = compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))
    return cfg, rcfg, params, rparams, mesh


def _prompt(seed, shape, cfg):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


def test_smoke_config_is_the_references(setup):
    cfg, rcfg, params, _, _ = setup
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
              "pattern_local", "pattern_global", "local_window", "rope_theta",
              "rope_theta_global", "tie_embeddings", "norm_eps", "attn_impl", "attn_chunk"):
        assert getattr(cfg, f) == getattr(rcfg, f), f
    full, rfull = registry.get_config(ARCH), ref_registry.get_config(ARCH)
    assert dataclasses.asdict(full) == {k: v for k, v in dataclasses.asdict(rfull).items()
                                       if k in dataclasses.asdict(full)}
    assert full.n_params() == rfull.n_params() == 11_765_395_200
    fresh = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for stack in ("local_layers", "global_layers"):
        assert {k: tuple(v.shape) for k, v in fresh[stack].items()} == {
            k: tuple(v.shape) for k, v in params[stack].items()}
    assert sum(v.numel() for v in jax.tree.leaves(reference_tree(fresh))) == cfg.n_params()


@pytest.mark.parametrize("impl", ["full", "flash_scan", "kernel"])
def test_prefill_step_matches_reference(setup, impl):
    """Whole-prompt logits of a 40-token prompt (past the 16-token window),
    attention chunked by 16; the reference runs ``pallas`` for ``kernel``
    (its Pallas kernel in interpret mode), the port its plain version."""
    cfg, rcfg, params, rparams, mesh = setup
    cfg = registry.override(cfg, attn_impl=impl, attn_chunk=16)
    rcfg = dataclasses.replace(rcfg, attn_impl="pallas" if impl == "kernel" else impl,
                               attn_chunk=16)
    tokens = _prompt(0, (2, 40), cfg)
    ours = serve.make_prefill_step(cfg, device="cpu")(
        params, {"tokens": torch.from_numpy(tokens).long()})
    rstep, _ = ref_serve.make_prefill_step(rcfg, mesh)
    theirs = jax.jit(rstep)(rparams, {"tokens": jnp.asarray(tokens)})
    assert ours.shape == (2, cfg.vocab)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL, rtol=0)


def _reference_scan_prefill(rcfg, rparams, mesh, prompt, slots, slot):
    """The reference's admission: its decode step scanned over the padded
    prompt into one slot of a contiguous cache."""
    rprefill, _ = ref_serve.make_slot_prefill_step(rcfg, mesh, MAX_PROMPT)
    padded = np.zeros(MAX_PROMPT, np.int32)
    padded[:prompt.shape[0]] = prompt
    cache = ref_tf.init_cache(rcfg, slots, MAX_LEN)
    return jax.jit(rprefill)(rparams, jnp.asarray(padded), jnp.int32(prompt.shape[0]), cache,
                             jnp.int32(slot))


@pytest.mark.parametrize("plen", [10, 16, 29])
def test_one_forward_prefill_cache_matches_reference_scan(setup, plen):
    """The port admits a prompt with one causal forward; the reference scans
    its decode step.  Same last logits, and the same cache: global rows
    [0, plen), local rows at p % 16 for the last 16 positions, zeros
    elsewhere (the slot was dirty before the admission in the port)."""
    cfg, rcfg, params, rparams, mesh = setup
    prompt = _prompt(plen, (plen,), cfg)
    rlast, rcache = _reference_scan_prefill(rcfg, rparams, mesh, prompt, slots=3, slot=1)
    cache = transformer.init_cache(cfg, 3, MAX_LEN, device="cpu")
    for leaf in cache.values():
        leaf.normal_()  # a previous request's rows must not survive
    before = {n: leaf.clone() for n, leaf in cache.items()}
    last = serve.make_slot_prefill_step(cfg, MAX_PROMPT)(
        params, torch.from_numpy(prompt).long(), cache, 1)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), atol=ATOL, rtol=0)
    assert set(cache) == set(rcache) == {"local_k", "local_v", "global_k", "global_v"}
    for n, leaf in cache.items():
        ax = serve.CACHE_BATCH_AXIS[n]
        assert tuple(leaf.shape) == rcache[n].shape
        np.testing.assert_allclose(leaf.select(ax, 1).numpy(),
                                   np.take(np.asarray(rcache[n]), 1, axis=ax), atol=ATOL, rtol=0)
        for other in (0, 2):
            assert torch.equal(leaf.select(ax, other), before[n].select(ax, other))


def test_greedy_decode_past_the_window_matches_reference(setup):
    """A 12-token prompt, then 24 greedy decode steps (positions 12..35:
    the local caches wrap twice): logits each step and tokens identical."""
    cfg, rcfg, params, rparams, mesh = setup
    prompts = _prompt(3, (2, 12), cfg)
    # reference: decode the prompt token by token, then greedily
    rstep = jax.jit(lambda p, t, c, n: ref_tf.forward_decode(p, t, c, n, rcfg))
    rcache = ref_tf.init_cache(rcfg, 2, MAX_LEN)
    for i in range(12):
        rlogits, rcache = rstep(rparams, jnp.asarray(prompts[:, i]), rcache, jnp.int32(i))
    # port: one causal forward per slot, then the contiguous decode step
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
        logits = step(params, torch.from_numpy(tok).long(), cache,
                      torch.full((2,), i), active)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), atol=ATOL, rtol=0)
    for n, leaf in cache.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(rcache[n]), atol=ATOL, rtol=0)


def test_inactive_slots_keep_their_cache(setup):
    """``active`` False: the slot's rows stay as they were (the reference's
    select_slots), its logits are computed but unused."""
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
        assert not torch.equal(leaf.select(ax, 0), before[n].select(ax, 0))


@pytest.mark.parametrize("arch,override", [(ARCH, {}), ("llama3.2-1b", {"sliding_window": 16})])
def test_rolling_windows_are_not_pageable(arch, override):
    """gemma3 (and any config whose window is shorter than the cache)
    through ``llm_decode_paged`` raises, in the port as in the reference,
    with the reference's message."""
    cfg = registry.override(registry.get_smoke_config(arch), **override)
    rcfg = dataclasses.replace(ref_registry.get_smoke_config(arch), **override)
    with pytest.raises(ValueError) as theirs:
        ref_serve.validate_pageable(rcfg, MAX_LEN)
    with pytest.raises(ValueError) as ours:
        serve.validate_pageable(cfg, MAX_LEN)
    assert str(ours.value) == str(theirs.value)
    assert "use the contiguous pool" in str(ours.value)
    with pytest.raises(ValueError, match="not pageable"):
        make_workload("llm_decode_paged", cfg=cfg, slots=2, max_len=MAX_LEN,
                      max_prompt_len=MAX_PROMPT, device="cpu", block_size=8)
    serve.validate_pageable(registry.override(cfg, sliding_window=None, pattern_local=0,
                                              pattern_global=0, local_window=None), MAX_LEN)


def test_training_a_grouped_stack_is_refused(setup):
    """No longer refused: the grouped stack trains (its parity against the
    reference: ``test_torch_train_families.py``); one step builds and runs
    with finite values."""
    from repro_torch.distributed import step as step_lib

    step = step_lib.make_train_step(setup[0], step_lib.TrainConfig(), dp=1, device="cpu")
    state = step.init_state(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 5), dtype=torch.long)
    _, m = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
