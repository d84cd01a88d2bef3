"""Parity helpers shared by the port's model tests: the reference's and
the port's decoders driven side by side on the CPU (cached prefill and
greedy decode, a block-paged continuation, the serving engine and the
serving CLI), the reference's weights carried across by
``repro_torch.models.convert``."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import compat
from repro.configs import registry as ref_registry
from repro.distributed import step as ref_step
from repro.launch import serve as ref_cli
from repro.models import transformer as ref_tf
from repro.serving import Request as RefRequest
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServeEngine as RefServeEngine
from repro.serving import make_workload as ref_make_workload
from repro_torch.configs import registry
from repro_torch.distributed import step as step_lib
from repro_torch.launch import serve as cli
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_reference
from repro_torch.serving import Request, ServeConfig, ServeEngine, make_workload

SCALE_RTOL, TIE_SHARE = 1e-5, 1e-3
BIAS_STD = 0.5


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def as_long(a):
    return torch.from_numpy(np.asarray(a)).long()


def mesh():
    return compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))


def with_random_biases(rparams, seed: int = 11):
    """The reference's tree with random qkv biases (it initialises them to 0)."""
    attn = rparams["layers"]["attn"]
    if "bq" in attn:
        rng = np.random.default_rng(seed)
        for n in ("bq", "bk", "bv"):
            attn[n] = jnp.asarray(rng.standard_normal(attn[n].shape).astype(np.float32)
                                  * BIAS_STD)
    return rparams


def assert_caches_close(ref_cache, cache, atol):
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
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=n)


def cached_decode(cfg, rcfg, rp, params, *, B, S, steps, atol):
    """The cached prefill of a [B, S] prompt, then ``steps`` greedy decode
    steps: logits, caches and tokens against the reference's."""
    prompt = tokens(1, (B, S), cfg.vocab)
    m = mesh()
    ref_prefill, _ = ref_step.make_cached_prefill_step(rcfg, m)
    ref_decode, _ = ref_step.make_serve_step(rcfg, m)
    ref_decode = jax.jit(ref_decode)
    with m:
        rl, rc = jax.jit(ref_prefill)(rp, jnp.asarray(prompt),
                                      ref_tf.init_cache(rcfg, B, S + steps))
    logits, c = step_lib.make_cached_prefill_step(cfg)(
        params, as_long(prompt), transformer.init_cache(cfg, B, S + steps, "cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), rtol=0, atol=atol)
    assert_caches_close(rc, c, atol)
    decode = step_lib.make_serve_step(cfg)
    for i in range(steps):
        rt, t = jnp.argmax(rl, -1).astype(jnp.int32), torch.argmax(logits, -1)
        np.testing.assert_array_equal(t.numpy(), np.asarray(rt), err_msg=f"token {i}")
        with m:
            rl, rc = ref_decode(rp, rt, rc, jnp.int32(S + i))
        logits, c = decode(params, t, c, S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rl), rtol=0, atol=atol,
                                   err_msg=f"step {i}")
    assert_caches_close(rc, c, atol)


def paged_state(cache, lengths, bs, seed):
    """A contiguous cache [L, B, W, KV, hd] scattered into a pool of blocks
    of ``bs`` positions over a permuted table (block 0 the trash block)."""
    k = np.asarray(cache["k"])
    L, B, W = k.shape[:3]
    nb = W // bs
    tables = np.random.default_rng(seed).permutation(np.arange(1, B * nb + 1))
    tables = tables.reshape(B, nb).astype(np.int32)
    pages = {}
    for n in ("k", "v"):
        leaf = np.asarray(cache[n])
        pool = np.zeros((L, B * nb + 1, bs) + leaf.shape[3:], leaf.dtype)
        for b in range(B):
            for j in range(nb):
                pool[:, tables[b, j]] = leaf[:, b, j * bs:(j + 1) * bs]
        pages[n] = pool
    return pages, tables, np.asarray(lengths, np.int32)


def paged_decode_matches_reference(cfg, rcfg, rp, params, *, steps, atol, bs=8, S=12, W=40):
    """``steps`` greedy decode steps on a block-paged cache of ``W``
    positions a sequence (the kernel path: its plain version on the CPU)
    from a cache the reference filled with prompts of ``S`` and 5 tokens,
    against the reference's paged step."""
    B = 2
    m = mesh()
    prompt = tokens(2, (B, S), cfg.vocab)
    ref_prefill, _ = ref_step.make_cached_prefill_step(rcfg, m)
    with m:
        _, rc = jax.jit(ref_prefill)(rp, jnp.asarray(prompt), ref_tf.init_cache(rcfg, B, W))
    pages, tables, lengths = paged_state(rc, [S, 5], bs, seed=4)
    ref_step_fn = jax.jit(lambda p, t, pg, tb, ln: ref_tf.forward_decode_paged(
        p, t, pg, tb, {}, ln, rcfg, block_size=bs))
    rpages = {n: jnp.asarray(v) for n, v in pages.items()}
    tpages = {n: torch.from_numpy(v.copy()) for n, v in pages.items()}
    tok = tokens(3, (B,), cfg.vocab)
    for i in range(steps):
        rl, rpages, _ = ref_step_fn(rp, jnp.asarray(tok), rpages, jnp.asarray(tables),
                                    jnp.asarray(lengths + i))
        logits, tpages, _ = transformer.forward_decode_paged(
            params, as_long(tok), tpages, torch.from_numpy(tables),
            torch.from_numpy(lengths + i), cfg, block_size=bs)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rl), rtol=0, atol=atol,
                                   err_msg=f"step {i}")
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(), tok)
    for n in ("k", "v"):  # block 0 is the trash block
        np.testing.assert_allclose(tpages[n][:, 1:].numpy(), np.asarray(rpages[n])[:, 1:],
                                   rtol=0, atol=atol)


SLOTS, MAX_PROMPT, MAX_LEN = 3, 24, 48
ARRIVALS = [0, 0, 1, 3]
PLENS = [6, 24, 13, 9]
MAX_NEW = [18, 7, 20, 12]


def engine_requests(cfg, cls):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in PLENS]
    return [cls(id=i, arrival=ARRIVALS[i], prompt=prompts[i], max_new=MAX_NEW[i])
            for i in range(len(PLENS))]


def assert_same_results(res, ref_res):
    assert sorted(res) == sorted(ref_res)
    for i, r in ref_res.items():
        np.testing.assert_array_equal(res[i].output, r.output, err_msg=f"request {i}")
        assert (res[i].admit_tick, res[i].retire_tick) == (r.admit_tick, r.retire_tick)
        assert res[i].n_tokens == r.n_tokens


def engine_matches_reference(arch, dp, rp, params, workload="llm_decode", **kw):
    cfg, rcfg = registry.get_smoke_config(arch), ref_registry.get_smoke_config(arch)
    rwl = ref_make_workload(workload, cfg=rcfg, mesh=mesh(), slots=SLOTS, max_len=MAX_LEN,
                            max_prompt_len=MAX_PROMPT, params=rp, **kw)
    ref_res = RefServeEngine(rwl, RefServeConfig(dp=dp)).run(engine_requests(rcfg, RefRequest))
    wl = make_workload(workload, cfg=cfg, slots=SLOTS, max_len=MAX_LEN,
                       max_prompt_len=MAX_PROMPT, device="cpu", params=params, **kw)
    eng = ServeEngine(wl, ServeConfig(dp=dp))
    assert_same_results(eng.run(engine_requests(cfg, Request)), ref_res)
    assert eng.summary()["completed"] == len(PLENS) and wl.prefills == len(PLENS)


def cli_matches_reference(monkeypatch, argv):
    """The serving CLI's run against the reference CLI's with the same
    arguments, the reference's weights carried across."""
    engines = []

    class Recorded(RefServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(ref_cli, "ServeEngine", Recorded)
    ref_cli.main(argv)
    ref_eng = engines[0]
    cfg = registry.get_smoke_config(argv[argv.index("--arch") + 1])
    converted = params_from_reference(jax.tree.map(np.asarray, ref_eng.workload.params), cfg,
                                      device="cpu")
    monkeypatch.setattr(cli, "make_workload",
                        functools.partial(make_workload, params=converted))
    eng = cli.main(argv + ["--device", "cpu"])
    assert_same_results(eng.results, ref_eng.results)
    return eng


