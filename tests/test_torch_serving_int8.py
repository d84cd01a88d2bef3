"""The port's int8 KV cache and static-path step factories against the
reference's, on the smoke llama3.2-1b (fp32) with converted weights, on the
CPU.

- **int8 decode**: 10 teacher-forced ``forward_decode`` steps from an empty
  int8 cache: logits within 1e-5 of the reference's (their largest
  magnitude is ~0.6); the int8 rows equal, except that a row quantized
  across a rounding tie may be off by one (at most 1 in 1,000 rows, none
  seen on this machine); the scales within a relative 1e-5.
- **Cached prefill**: ``make_cached_prefill_step`` (one causal forward;
  over an int8 cache K/V quantized then dequantized before the attention)
  against the reference's (its decode step scanned over the prompt), bf16
  (the smoke config's fp32 compute type) and int8 caches: last logits
  within 1e-5, float leaves within 1e-5, int8 rows as above; 4 greedy
  tokens from each cache equal.
- **Serving**: the int8 contiguous pool gives the reference engine's
  tokens and ticks; the int8 paged gather path gives the contiguous int8
  pool's tokens; the paged kernel path refuses int8 pages.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.distributed import step as ref_step  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro.serving import make_workload as ref_make_workload  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import serve as dserve  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving import Request, ServeConfig, ServeEngine, make_workload  # noqa: E402

ARCH = "llama3.2-1b"
LOGITS_ATOL = 1e-5
FLOAT_ATOL = 1e-5
SCALE_RTOL = 1e-5
TIE_SHARE = 1e-3  # int8 rows allowed off by one (a rounding tie), as a share of all


def _cfgs(dtype):
    rcfg, cfg = ref_registry.get_smoke_config(ARCH), registry.get_smoke_config(ARCH)
    return (dataclasses.replace(rcfg, kv_cache_dtype=dtype),
            dataclasses.replace(cfg, kv_cache_dtype=dtype))


@pytest.fixture(scope="module")
def weights():
    rp = ref_transformer.init_params(ref_registry.get_smoke_config(ARCH), jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, rp)
    return rp, np_params, params_from_reference(np_params, registry.get_smoke_config(ARCH),
                                                device="cpu")


def _mesh():
    return compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))


def _assert_caches_close(ref_cache, cache):
    assert sorted(ref_cache) == sorted(cache)
    for n, a in ref_cache.items():
        a, b = np.asarray(a), cache[n].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, n
        if a.dtype == np.int8:
            off = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert off.max() <= 1 and (off > 0).mean() <= TIE_SHARE, (n, off.max(), off.sum())
        elif n.endswith("_scale"):
            np.testing.assert_allclose(b, a, rtol=SCALE_RTOL, atol=0, err_msg=n)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=FLOAT_ATOL, err_msg=n)


def test_int8_decode_matches_reference(weights):
    rp, _, params = weights
    rcfg, cfg = _cfgs("int8")
    B, S = 2, 10
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    rc = ref_transformer.init_cache(rcfg, B, S)
    c = transformer.init_cache(cfg, B, S, "cpu")
    assert c["k"].dtype == torch.int8 and c["k_scale"].shape == c["k"].shape[:-1]
    for i in range(S):
        rl, rc = ref_transformer.forward_decode(rp, jnp.asarray(toks[:, i]), rc, jnp.int32(i),
                                                rcfg)
        logits, c = transformer.forward_decode(params, torch.from_numpy(toks[:, i]).long(), c,
                                               torch.full((B,), i), cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rl), rtol=0, atol=LOGITS_ATOL,
                                   err_msg=f"step {i}")
    _assert_caches_close(rc, c)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_cached_prefill_matches_reference(weights, dtype):
    rp, _, params = weights
    rcfg, cfg = _cfgs(dtype)
    B, S, G = 2, 8, 4
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    mesh = _mesh()
    ref_prefill, _ = ref_step.make_cached_prefill_step(rcfg, mesh)
    ref_serve, _ = ref_step.make_serve_step(rcfg, mesh)
    with mesh:
        rl, rc = jax.jit(ref_prefill)(rp, jnp.asarray(prompt),
                                      ref_transformer.init_cache(rcfg, B, S + G))
    logits, c = step_lib.make_cached_prefill_step(cfg)(
        params, torch.from_numpy(prompt).long(), transformer.init_cache(cfg, B, S + G, "cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), rtol=0, atol=LOGITS_ATOL)
    _assert_caches_close(rc, c)
    serve = step_lib.make_serve_step(cfg)
    rt, t = jnp.argmax(rl, -1).astype(jnp.int32), torch.argmax(logits, -1)
    for i in range(G):
        np.testing.assert_array_equal(t.numpy(), np.asarray(rt), err_msg=f"token {i}")
        with mesh:
            rl, rc = ref_serve(rp, rt, rc, jnp.int32(S + i))
        logits, c = serve(params, t, c, S + i)
        rt, t = jnp.argmax(rl, -1).astype(jnp.int32), torch.argmax(logits, -1)


def test_int8_cache_bytes_and_refused_layouts():
    full = registry.get_config(ARCH)
    full8 = dataclasses.replace(full, kv_cache_dtype="int8")
    nbytes = [sum(t.numel() * t.element_size()
                  for t in transformer.init_cache(c, 2, 16, "cpu").values()) for c in (full, full8)]
    hd = full.head_dim
    assert nbytes[1] * 2 * hd == nbytes[0] * (hd + 4)  # (hd + 4) / (2 hd) = 0.531 at hd 64
    for arch in ("gemma3-12b", "falcon-mamba-7b"):
        with pytest.raises(ValueError, match="int8"):
            dataclasses.replace(registry.get_smoke_config(arch), kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        dataclasses.replace(full, kv_cache_dtype="fp8")


def _requests(cls, vocab):
    rng = np.random.default_rng(4)
    return [cls(id=i, arrival=[0, 0, 1, 3, 4][i],
                prompt=rng.integers(0, vocab, size=n).astype(np.int32), max_new=m)
            for i, (n, m) in enumerate(zip((5, 12, 3, 9, 7), (9, 6, 11, 8, 10)))]


def test_int8_pools_match_reference_engine_and_each_other(weights):
    _, np_params, _ = weights
    rcfg, cfg = _cfgs("int8")
    rwl = ref_make_workload("llm_decode", cfg=rcfg, mesh=_mesh(), slots=2, max_len=24,
                            max_prompt_len=12, seed=0, params=jax.tree.map(jnp.asarray, np_params))
    ref_res = RefServeEngine(rwl, RefServeConfig(dp=3)).run(_requests(RefRequest, cfg.vocab))
    runs = {}
    for name, kw in (("llm_decode", {}), ("llm_decode_paged", {"block_size": 8,
                                                               "attn": "gather"})):
        wl = make_workload(name, cfg=cfg, slots=2, max_len=24, max_prompt_len=12, device="cpu",
                           params=params_from_reference(np_params, cfg, device="cpu"), **kw)
        runs[name] = ServeEngine(wl, ServeConfig(dp=3)).run(_requests(Request, cfg.vocab))
        if name == "llm_decode_paged":
            assert wl.pool.pages["k"].dtype == torch.int8 and "v_scale" in wl.pool.pages
            assert wl.pool.allocator.used_blocks == 0
    for i, r in ref_res.items():
        for res in runs.values():
            np.testing.assert_array_equal(res[i].output, r.output)
            assert (res[i].admit_tick, res[i].retire_tick) == (r.admit_tick, r.retire_tick)


def test_int8_paged_kernel_path_raises():
    _, cfg = _cfgs("int8")
    with pytest.raises(NotImplementedError, match="gather"):
        make_workload("llm_decode_paged", cfg=cfg, slots=2, max_len=24, max_prompt_len=12,
                      block_size=8, attn="kernel", device="cpu")
    pages = dserve.init_paged_pool(cfg, 24, 7, 8, "cpu")
    assert set(pages) == {"k", "v", "k_scale", "v_scale"}
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="gather"):
        transformer.forward_decode_paged(params, torch.zeros(2, dtype=torch.long), pages,
                                         torch.ones((2, 3), dtype=torch.int32),
                                         torch.ones(2, dtype=torch.int32), cfg, block_size=8)


def test_int8_greedy_close_to_the_float_cache(weights):
    """The reference test's bar: teacher-forced logits of the int8 cache
    within 6% of the float cache's largest logit at every step."""
    _, _, params = weights
    _, cfg8 = _cfgs("int8")
    cfg = registry.get_smoke_config(ARCH)
    B, S = 2, 10
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, size=(B, S)))
    c16, c8 = (transformer.init_cache(c, B, S, "cpu") for c in (cfg, cfg8))
    serve16, serve8 = step_lib.make_serve_step(cfg), step_lib.make_serve_step(cfg8)
    for i in range(S):
        l16, c16 = serve16(params, toks[:, i], c16, i)
        l8, c8 = serve8(params, toks[:, i], c8, i)
        assert float((l8 - l16).abs().max() / l16.abs().max()) < 0.06, i
