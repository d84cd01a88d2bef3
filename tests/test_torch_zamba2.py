"""The port's zamba2 (hybrid stack: mamba2 groups and one shared attention
block) against the reference's.

Smoke zamba2-2.7b in fp32 (4 mamba2 layers in 2 groups of 2, d 64,
d_inner 128, 8 SSM heads of 16 channels, state 16, conv 4; the shared
block 4/4 heads at hd 16; vocab 256), the reference's ``init_params``
carried across by ``repro_torch.models.convert``.  The reference
initialises A_log, D, dt_bias, conv_b and the norms to constants, so the
tree gets random values there before it is converted (an unconverted
constant would test nothing).  Both sides scan SSD chunks of 16 tokens
here (``ssm_chunk``), so a 40-token prompt ends in a ragged chunk.

Tolerances: the SSD scan and a mamba2 block within 1e-5 (fp32 sums of at
most a chunk's terms in another order); the one-forward prefill state and
logits against the reference's decode scan, and decode logits, within
1e-4 (the chunked scan and the recurrence sum in other orders through 4
layers and a 256-way head); whole-prompt logits rtol = atol = 5e-4, as
the reference's own ``tests/test_models_smoke.py`` holds its decode to
its forward; tokens, admission and retirement ticks identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.distributed import serve as ref_serve  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.layers import rmsnorm as ref_rmsnorm  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro.serving import make_workload as ref_make_workload  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import serve  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import layers, ssm, transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference, reference_tree  # noqa: E402
from repro_torch.serving import PagedDecodePool, Request, ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serving import make_workload  # noqa: E402
from torch_model_ref import assert_same_results, cli_matches_reference, mesh  # noqa: E402

ARCH = "zamba2-2.7b"
CHUNK = 16
SCAN_TOL = 1e-5
ATOL = 1e-4
MAX_LEN, MAX_PROMPT, BS = 64, 40, 8


def _randomize(rparams, seed):
    """Random values where the reference initialises constants: A_log, D,
    dt_bias (dt = softplus in (0.02, 0.7)), conv_b, the gated norm, the
    layer norms, the shared block's norms and the final norm."""
    rng = np.random.default_rng(seed)

    def draw(a, lo=None, hi=None, std=0.1, mean=0.0):
        shape, dtype = a.shape, a.dtype
        x = (rng.uniform(lo, hi, shape) if lo is not None
             else mean + std * rng.standard_normal(shape))
        return jnp.asarray(x.astype(np.float32), dtype)

    m = rparams["mamba_groups"]["mamba"]
    m["A_log"] = draw(m["A_log"], np.log(0.5), np.log(8.0))
    m["D"] = draw(m["D"], mean=1.0, std=0.5)
    m["dt_bias"] = draw(m["dt_bias"], -4.0, 0.0)
    for n in ("conv_b", "norm_w"):
        m[n] = draw(m[n])
    rparams["mamba_groups"]["ln"] = draw(rparams["mamba_groups"]["ln"])
    for n in ("ln1", "ln2"):
        rparams["shared_attn"][n] = draw(rparams["shared_attn"][n])
    rparams["final_norm"] = draw(rparams["final_norm"])
    return rparams


@pytest.fixture(scope="module")
def setup():
    cfg = registry.override(registry.get_smoke_config(ARCH), ssm_chunk=CHUNK)
    rcfg = dataclasses.replace(ref_registry.get_smoke_config(ARCH), ssm_chunk=CHUNK)
    rparams = _randomize(ref_tf.init_params(rcfg, jax.random.PRNGKey(0)), 1)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, rcfg, params, rparams


def _prompt(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _layer(params, rparams, g, i):
    lp = {k: v[g, i] for k, v in params["mamba_groups"].items()}
    rlp = jax.tree.map(lambda a: a[g, i], rparams["mamba_groups"])
    return lp, rlp


# --- configuration ----------------------------------------------------------


def _meta_params(cfg):
    """The port's full-width parameter dict with every drawn matrix on the
    meta device (shapes only: 4.8 GB of weights are not made)."""
    def meta(gen, shape, dtype, **kw):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")

    with pytest.MonkeyPatch.context() as mp:
        for mod in (ssm, transformer, layers):
            mp.setattr(mod, "dense_init", meta)
        mp.setattr(transformer, "embed_init", meta)
        return transformer.init_params(cfg, torch.Generator(), device="cpu")


def test_configs_and_n_params_are_the_references(setup):
    """Both configs field for field, the reference's analytic ``n_params``
    (2,422,378,208 at full width), and the real tensors: the port's dict
    holds each layer's conv_b [di + 2 N] and two of its three [nh] vectors
    more than that count (54 x 5,408 = 292,032 at full width)."""
    for ours, theirs in ((registry.get_smoke_config(ARCH), ref_registry.get_smoke_config(ARCH)),
                         (registry.get_config(ARCH), ref_registry.get_config(ARCH))):
        ours_d, theirs_d = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert ours_d == {k: v for k, v in theirs_d.items() if k in ours_d}, ours.name
        assert (ours.d_inner, ours.ssm_nheads, ours.n_groups) == (
            theirs.d_inner, theirs.ssm_nheads, theirs.n_layers // theirs.attn_every)
        assert ours.n_params() == theirs.n_params()
        extra = ours.n_layers * (ours.d_inner + 2 * ours.ssm_state + 2 * ours.ssm_nheads)
        params = (_meta_params(ours) if ours.param_dtype == "bfloat16" else
                  transformer.init_params(ours, torch.Generator().manual_seed(0), "cpu"))
        counted = sum(v.numel() for v in jax.tree.leaves(reference_tree(params)))
        assert counted == ours.n_params() + extra, ours.name
    full = registry.get_config(ARCH)
    assert full.n_params() == 2_422_378_208
    assert full.n_layers * (full.d_inner + 2 * full.ssm_state + 2 * full.ssm_nheads) == 292_032
    cfg, _, params, rparams = setup
    fresh = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for tree in ("mamba_groups", "shared_attn"):
        assert {k: (tuple(v.shape), v.dtype) for k, v in fresh[tree].items()} == {
            k: (tuple(v.shape), v.dtype) for k, v in params[tree].items()}
    assert sum(v.numel() for v in jax.tree.leaves(reference_tree(fresh))) == sum(
        np.size(v) for v in jax.tree.leaves(rparams))


def test_refusals():
    """An unknown family (the audio family is ported now), mamba2 only in
    the hybrid family, the hybrid stack's own rules; no int8 cache (no
    scale planes for attn_k/attn_v)."""
    full = registry.get_config(ARCH)
    with pytest.raises(ValueError, match="unknown family"):
        registry.override(full, family="encoder")
    with pytest.raises(ValueError, match="mamba2 is not ported outside the hybrid family"):
        registry.override(registry.get_config("falcon-mamba-7b"), ssm_version=2)
    with pytest.raises(ValueError, match="hybrid family is mamba2"):
        registry.override(full, ssm_version=1)
    with pytest.raises(ValueError, match="attn_every > 0 dividing n_layers"):
        registry.override(full, attn_every=5)
    with pytest.raises(ValueError, match="ssm_headdim"):
        registry.override(full, ssm_headdim=48)
    with pytest.raises(ValueError, match="int8 KV cache"):
        registry.override(full, kv_cache_dtype="int8")


def test_training_the_hybrid_family_is_refused(setup):
    """No longer refused: the hybrid stack trains (its parity against the
    reference: ``test_torch_train_families.py``); one step builds and runs
    with finite values."""
    from repro_torch.distributed import step as step_lib

    step = step_lib.make_train_step(setup[0], step_lib.TrainConfig(), dp=1, device="cpu")
    state = step.init_state(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 5), dtype=torch.long)
    _, m = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


def test_fp32_leaves_stay_fp32_from_a_bf16_tree():
    """The reference keeps A_log, D and dt_bias in fp32 whatever the param
    dtype; the conversion must not round them to bf16."""
    rcfg = dataclasses.replace(ref_registry.get_smoke_config(ARCH), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    cfg = registry.override(registry.get_smoke_config(ARCH), param_dtype="bfloat16",
                            compute_dtype="bfloat16")
    rparams = _randomize(ref_tf.init_params(rcfg, jax.random.PRNGKey(1)), 2)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    fp32 = ("A_log", "D", "dt_bias")
    for k, leaf in params["mamba_groups"].items():
        assert leaf.dtype == (torch.float32 if k in fp32 else torch.bfloat16), k
    for k in fp32:
        np.testing.assert_array_equal(params["mamba_groups"][k].numpy(),
                                      np.asarray(rparams["mamba_groups"]["mamba"][k]))
    fresh = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(fresh["mamba_groups"][k].dtype == torch.float32 for k in fp32)


# --- mamba2 -----------------------------------------------------------------


@pytest.mark.parametrize("S,chunk,from_h0", [(1, 16, False), (37, 16, False), (64, 16, True),
                                             (37, 8, True)])
def test_ssd_scan_matches_reference(S, chunk, from_h0):
    """S = 1, a ragged last chunk, several chunks from a nonzero h0: y and
    the final state (a padded step must leave the state as it was)."""
    B, nh, hp, st = 2, 4, 8, 16
    rng = np.random.default_rng(S + chunk)
    xh = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    Bs, Cs = (rng.standard_normal((B, S, st)).astype(np.float32) for _ in range(2))
    dt = np.log1p(np.exp(rng.uniform(-4, 0, (B, S, nh)))).astype(np.float32)
    A = -rng.uniform(0.5, 8, nh).astype(np.float32)
    h0 = (rng.standard_normal((B, nh, hp, st)) * (0.5 if from_h0 else 0)).astype(np.float32)
    y, h = ssm._ssd_scan(*map(_t, (xh, Bs, Cs, dt, A, h0)), chunk)
    ry, rh = ref_ssm._ssd_scan(*map(jnp.asarray, (xh, Bs, Cs, dt, A, h0)), chunk)
    assert y.shape == (B, S, nh, hp) and h.shape == (B, nh, hp, st)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("S", [1, 3, 40])
def test_mamba2_block_and_final_state_match_reference(setup, S):
    """One layer over S tokens: the output, and the state it leaves equals
    the reference's decode step scanned over the same inputs."""
    cfg, rcfg, params, rparams = setup
    lp, rlp = _layer(params, rparams, 1, 0)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ours, state = ssm.mamba2_apply(lp, _t(x), cfg)
    theirs = ref_ssm.mamba2_apply(rlp["mamba"], jnp.asarray(x), rcfg, chunk=min(CHUNK, S))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=SCAN_TOL, rtol=SCAN_TOL)
    rstate = ref_ssm.mamba2_init_state(rcfg, 2, jnp.float32)
    step = jax.jit(lambda p, x_t, st: ref_ssm.mamba2_decode(p, x_t, st, rcfg))
    for t in range(S):
        _, rstate = step(rlp["mamba"], jnp.asarray(x[:, t]), rstate)
    for n in ("h", "conv"):
        assert tuple(state[n].shape) == rstate[n].shape
        np.testing.assert_allclose(state[n].numpy(), np.asarray(rstate[n]), atol=ATOL, rtol=0)


def test_mamba2_decode_matches_reference(setup):
    """One step from a nonzero state; in place, and with write_ok a row
    keeps its own state."""
    cfg, rcfg, params, rparams = setup
    lp, rlp = _layer(params, rparams, 0, 1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    h = (rng.standard_normal((3, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)) * 0.3
         ).astype(np.float32)
    conv = rng.standard_normal((3, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
                               ).astype(np.float32)
    theirs, rnew = ref_ssm.mamba2_decode(rlp["mamba"], jnp.asarray(x),
                                         {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}, rcfg)
    for write_ok in (None, torch.tensor([True, False, True])):
        state = {"h": _t(h), "conv": _t(conv)}
        ours = ssm.mamba2_decode(lp, _t(x), state, cfg, write_ok)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=SCAN_TOL, rtol=0)
        for n, old in (("h", h), ("conv", conv)):
            want = np.asarray(rnew[n]).copy()
            if write_ok is not None:
                want[1] = old[1]
            np.testing.assert_allclose(state[n].numpy(), want, atol=SCAN_TOL, rtol=0)


# --- the stack --------------------------------------------------------------


def test_last_logits_match_reference_full_sequence(setup):
    """The whole-prompt forward (and ``make_prefill_step``) of a 40-token
    prompt (chunks of 16: the last one ragged) against the reference's."""
    cfg, rcfg, params, rparams = setup
    tokens = _prompt(0, (2, 40), cfg.vocab)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.zeros((2, 40), jnp.int32)}
    x, _ = ref_tf._embed_inputs(rparams, batch, rcfg)
    h, _ = ref_tf._run_stack(rparams, x, rcfg, jnp.arange(40)[None, :])
    full = np.asarray(ref_tf._logits(rparams, ref_rmsnorm(h, rparams["final_norm"],
                                                          rcfg.norm_eps), rcfg))
    rstep, _ = ref_serve.make_prefill_step(rcfg, mesh())
    theirs = jax.jit(rstep)(rparams, {"tokens": jnp.asarray(tokens)})
    ours = transformer.forward_last_logits(params, torch.from_numpy(tokens).long(), cfg)
    step = serve.make_prefill_step(cfg, device="cpu")(params, {"tokens": torch.from_numpy(tokens)})
    for got in (ours, step):
        assert got.shape == (2, cfg.vocab) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), full[:, -1], rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs), rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def ref_prefill(setup):
    """The reference's admission (its decode step scanned over the padded
    prompt), jitted once."""
    _, rcfg, _, rparams = setup
    fn, _ = ref_serve.make_slot_prefill_step(rcfg, mesh(), MAX_PROMPT)
    fn = jax.jit(fn)

    def run(prompt, cache, slot):
        padded = np.zeros(MAX_PROMPT, np.int32)
        padded[:prompt.shape[0]] = prompt
        return fn(rparams, jnp.asarray(padded), jnp.int32(prompt.shape[0]), cache,
                  jnp.int32(slot))

    return run


@pytest.mark.parametrize("plen", [1, 2, 3, 4, 17, 40])
def test_one_forward_prefill_state_matches_reference_scan(setup, ref_prefill, plen):
    """The port admits a prompt with one forward (SSD chunks of 16: 40
    tokens end in a ragged chunk); the reference scans its decode step.
    Same last logits, and the same m_h, m_conv (zero-padded in front below
    K - 1 = 3 tokens) and attn_k/attn_v rows in the slot; the slot was
    dirty before, the other slots are untouched."""
    cfg, rcfg, params, _ = setup
    prompt = _prompt(plen, (plen,), cfg.vocab)
    rlast, rcache = ref_prefill(prompt, ref_tf.init_cache(rcfg, 3, MAX_LEN), 1)
    cache = transformer.init_cache(cfg, 3, MAX_LEN, device="cpu")
    for leaf in cache.values():
        leaf.normal_()  # a previous request's state must not survive
    before = {n: leaf.clone() for n, leaf in cache.items()}
    last = serve.make_slot_prefill_step(cfg, MAX_PROMPT)(
        params, torch.from_numpy(prompt).long(), cache, 1)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), atol=ATOL, rtol=0)
    assert set(cache) == set(rcache) == {"m_h", "m_conv", "attn_k", "attn_v"}
    for n, leaf in cache.items():
        ax = serve.CACHE_BATCH_AXIS[n]
        assert tuple(leaf.shape) == rcache[n].shape and leaf.dtype == torch.float32
        np.testing.assert_allclose(leaf.select(ax, 1).numpy(),
                                   np.take(np.asarray(rcache[n]), 1, axis=ax), atol=ATOL,
                                   rtol=0, err_msg=n)
        for other in (0, 2):
            assert torch.equal(leaf.select(ax, other), before[n].select(ax, other))


def _ref_pages(rcache, lengths, seed):
    """The reference's contiguous attn_k/attn_v [G, B, W, KV, hd] laid into a
    pool of BS-position blocks over a permuted table (block 0 the trash
    block), and its per-slot state."""
    k = np.asarray(rcache["attn_k"])
    G, B, W = k.shape[:3]
    nb = W // BS
    tables = np.random.default_rng(seed).permutation(np.arange(1, B * nb + 1))
    tables = tables.reshape(B, nb).astype(np.int32)
    pages = {}
    for n in ("attn_k", "attn_v"):
        leaf = np.asarray(rcache[n])
        pool = np.zeros((G, B * nb + 1, BS) + leaf.shape[3:], leaf.dtype)
        for b in range(B):
            for j in range(nb):
                pool[:, tables[b, j]] = leaf[:, b, j * BS:(j + 1) * BS]
        pages[n] = pool
    state = {n: np.asarray(rcache[n]) for n in ("m_h", "m_conv")}
    return pages, tables, np.asarray(lengths, np.int32), state


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_24_greedy_decode_steps_match_reference(setup, ref_prefill, pool):
    """Prompts of 12 and 33 tokens admitted by the port's pool (one forward
    each), then 24 greedy decode steps: tokens identical each step to the
    reference's ``forward_decode`` (contiguous: its pool step, a vmap of it
    over the slots) or ``forward_decode_paged``
    (paged, with its slot_state) from the reference's scanned admissions,
    and the final recurrent state within ATOL."""
    cfg, rcfg, params, rparams = setup
    plens = (12, 33)
    prompts = [_prompt(10 + p, (p,), cfg.vocab) for p in plens]
    rcache = ref_tf.init_cache(rcfg, 2, MAX_LEN)
    rlast = []
    for b, p in enumerate(prompts):
        last, rcache = ref_prefill(p, rcache, b)
        rlast.append(last)
    rtok = np.asarray(jnp.argmax(jnp.stack(rlast), -1)).astype(np.int32)
    lengths = np.asarray(plens, np.int32)
    if pool == "contiguous":
        rstep = jax.jit(ref_serve.make_pool_decode_step(rcfg, mesh())[0])
        wl = make_workload("llm_decode", cfg=cfg, slots=2, max_len=MAX_LEN,
                           max_prompt_len=MAX_PROMPT, device="cpu", params=params)
    else:
        rpages, tables, _, rstate = _ref_pages(rcache, plens, seed=4)
        rpages, rstate = ({n: jnp.asarray(v) for n, v in d.items()} for d in (rpages, rstate))
        rstep = jax.jit(lambda p, t, pg, st, n: ref_tf.forward_decode_paged(
            p, t, pg, jnp.asarray(tables), st, n, rcfg, block_size=BS))
        wl = make_workload("llm_decode_paged", cfg=cfg, slots=2, max_len=MAX_LEN,
                           max_prompt_len=MAX_PROMPT, device="cpu", params=params,
                           block_size=BS)
    toks = [wl.pool.admit(params, p, b, **({"max_new": 24} if pool == "paged" else {}))
            for b, p in enumerate(prompts)]
    np.testing.assert_array_equal(toks, rtok)
    active = np.ones(2, bool)
    for i in range(24):
        if pool == "contiguous":
            rl, rcache = rstep(rparams, jnp.asarray(rtok), rcache, jnp.asarray(lengths + i))
        else:
            rl, rpages, rstate = rstep(rparams, jnp.asarray(rtok), rpages, rstate,
                                       jnp.asarray(lengths + i))
        rtok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        np.testing.assert_array_equal(wl.pool.step(params, active).numpy(), rtok,
                                      err_msg=f"step {i}")
    state = wl.pool.cache if pool == "contiguous" else wl.pool.slot_state
    want = rcache if pool == "contiguous" else rstate
    for n in ("m_h", "m_conv"):
        np.testing.assert_allclose(state[n].numpy(), np.asarray(want[n]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("pool", ["llm_decode", "llm_decode_paged"])
def test_a_reused_slot_gives_the_tokens_of_a_fresh_pool(setup, pool):
    """Admission replaces the slot's recurrent state whole: a request
    admitted into a slot that served another one decodes as in a fresh
    pool."""
    cfg, _, params, _ = setup
    kw = {"block_size": BS} if pool == "llm_decode_paged" else {}
    first, second = _prompt(20, (30,), cfg.vocab), _prompt(21, (9,), cfg.vocab)

    def serve_one(wl, prompt, slot):
        extra = {"max_new": 12} if pool == "llm_decode_paged" else {}
        out = [wl.pool.admit(params, prompt, slot, **extra)]
        active = np.zeros(wl.slots, bool)
        active[slot] = True
        for _ in range(12):
            out.append(int(wl.pool.step(params, active)[slot]))
        return out

    used = make_workload(pool, cfg=cfg, slots=2, max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                         device="cpu", params=params, **kw)
    serve_one(used, first, 1)
    if pool == "llm_decode_paged":
        used.pool.release_slot(1)
    fresh = make_workload(pool, cfg=cfg, slots=2, max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                          device="cpu", params=params, **kw)
    assert serve_one(used, second, 1) == serve_one(fresh, second, 1)


# --- serving ----------------------------------------------------------------

SLOTS, ENGINE_PROMPT, ENGINE_LEN = 3, 24, 48
ARRIVALS = [0, 0, 1, 3, 4]
TAILS = [0, 8, 5, 1, 6]  # after a 16-token system prompt (two blocks of 8)
MAX_NEW = [18, 7, 20, 12, 9]


def _engine_requests(cls, vocab):
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, size=16).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, vocab, size=n)]).astype(np.int32)
               for n in TAILS]
    return [cls(id=i, arrival=ARRIVALS[i], prompt=prompts[i], max_new=MAX_NEW[i])
            for i in range(len(TAILS))]


@pytest.fixture(scope="module")
def engine_weights():
    rcfg = ref_registry.get_smoke_config(ARCH)
    rparams = _randomize(ref_tf.init_params(rcfg, jax.random.PRNGKey(3)), 4)
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   registry.get_smoke_config(ARCH), device="cpu")
    return rparams, params


@pytest.mark.parametrize("workload", ["llm_decode", "llm_decode_paged"])
@pytest.mark.parametrize("dp", [1, 3])
def test_engine_tokens_and_ticks_match_reference(engine_weights, dp, workload):
    """Five requests sharing a 16-token prefix over 3 slots (slots reused):
    every output token, admission and retirement tick equal to the
    reference engine's; on the paged pool with prefix sharing on (the
    shared blocks are skip-written) and off."""
    rparams, params = engine_weights
    cfg, rcfg = registry.get_smoke_config(ARCH), ref_registry.get_smoke_config(ARCH)
    kw = {"block_size": BS} if workload == "llm_decode_paged" else {}
    rwl = ref_make_workload(workload, cfg=rcfg, mesh=mesh(), slots=SLOTS, max_len=ENGINE_LEN,
                            max_prompt_len=ENGINE_PROMPT, params=rparams, **kw)
    ref_res = RefServeEngine(rwl, RefServeConfig(dp=dp)).run(
        _engine_requests(RefRequest, rcfg.vocab))
    for share in ((True, False) if kw else (None,)):
        extra = {} if share is None else {"share_prefixes": share}
        wl = make_workload(workload, cfg=cfg, slots=SLOTS, max_len=ENGINE_LEN,
                           max_prompt_len=ENGINE_PROMPT, device="cpu", params=params,
                           **kw, **extra)
        eng = ServeEngine(wl, ServeConfig(dp=dp))
        assert_same_results(eng.run(_engine_requests(Request, cfg.vocab)), ref_res)
        assert eng.summary()["completed"] == len(TAILS) and wl.prefills == len(TAILS)
        if share:
            assert wl.pool.prefix_saved_blocks > 0


def test_cli_serves_as_the_reference_cli(monkeypatch):
    eng = cli_matches_reference(monkeypatch, [
        "--arch", ARCH, "--smoke", "--continuous", "--workload", "llm_decode_paged",
        "--dp", "3", "--slots", "3", "--requests", "6"])
    assert eng.summary()["completed"] == 6


def test_static_batch_path_and_cache_bytes(capsys):
    """``--batch`` (one cached prefill, then greedy steps) at smoke size,
    and both pools' ``cache_bytes`` counting the recurrent state."""
    r = cli.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8", "--gen", "6",
                  "--device", "cpu"])
    assert r["tokens"].shape == (2, 6) and ((r["tokens"] >= 0) & (r["tokens"] < 256)).all()
    assert "sample token ids:" in capsys.readouterr().out
    cfg = registry.get_smoke_config(ARCH)
    paged = PagedDecodePool(cfg, slots=2, max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                            block_size=BS, device="cpu")
    state = sum(t.numel() * 4 for t in paged.slot_state.values())
    pages = sum(t.numel() * 4 for t in paged.pages.values())
    assert set(paged.slot_state) == {"m_h", "m_conv"} and set(paged.pages) == {"attn_k", "attn_v"}
    assert paged.cache_bytes == state + pages + paged.tables.numel() * 4
    assert tuple(paged.pages["attn_k"].shape) == (cfg.n_groups, paged.num_blocks, BS,
                                                  cfg.n_kv_heads, cfg.head_dim)
