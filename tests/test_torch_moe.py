"""The port's moe family (mixtral-8x7b, llama4-scout-17b-a16e) against the
reference's, on their fp32 smoke configs with the reference's weights
carried across by ``repro_torch.models.convert``.

- Every config field, ``n_params`` and ``n_active_params`` equal the
  reference's.
- ``moe.moe_apply`` against ``repro.models.moe.moe_apply`` on the same
  inputs: the routing indices exactly, the capacity ``keep`` mask exactly
  (the reference's own cumsum expressions over its indices), y within 2e-6
  and the aux loss within a relative 1e-6 (fp32 summation order); the
  ``dense`` oracle likewise; ``scatter`` equals ``dense`` where nothing is
  dropped (capacity_factor E / k).  The chunk rule at S = 2 x
  ``moe_seq_chunk`` (two groups a sequence) and 2 x ``moe_seq_chunk`` + 1
  (one group): y and the dropped count equal the reference's.
- Serving routes a token a group (the reference scans its decode step):
  the one-forward admission prefill's last logits and cache within 2e-5 of
  the reference's scan, with nothing dropped, where the full-sequence
  forward (``make_prefill_step``, a sequence a group) at capacity_factor
  0.5 drops what the reference drops and gives its logits.  The train
  forward's loss includes 0.01 x the summed aux loss, as the reference's.
- 24 greedy decode steps on the contiguous cache (mixtral's 32-token
  window wraps), bf16 (the smoke configs' fp32) and int8 (logits within
  1e-5, int8 rows equal but for a rounding tie), and on a block-paged
  cache: logits within 2e-5, tokens equal; the engine at dp 3 and the
  serving CLI: tokens and ticks equal.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.distributed import serve as ref_serve  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import serve  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference, reference_tree  # noqa: E402
from torch_model_ref import (  # noqa: E402
    as_long,
    cached_decode,
    cli_matches_reference,
    engine_matches_reference,
    mesh,
    paged_decode_matches_reference,
    tokens,
)

ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
TOL = dict(atol=2e-5, rtol=0)
MOE_ATOL, AUX_RTOL = 2e-6, 1e-6


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg, rcfg = registry.get_smoke_config(arch), ref_registry.get_smoke_config(arch)
    rp = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, rp)
    return cfg, rcfg, rp, np_params, params_from_reference(np_params, cfg, device="cpu")


def _layer0(arch):
    """Layer 0's moe parameters on both sides."""
    _, _, rp, _, params = _weights(arch)
    rlp = jax.tree.map(lambda a: a[0], rp["layers"]["moe"])
    return rlp, {k: params["layers"][k][0] for k in moe.LEAVES}


def _x(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    for get, rget in ((registry.get_config, ref_registry.get_config),
                      (registry.get_smoke_config, ref_registry.get_smoke_config)):
        cfg, rcfg = get(arch), rget(arch)
        ref_fields = dataclasses.asdict(rcfg)
        assert dataclasses.asdict(cfg) == {k: ref_fields[k] for k in dataclasses.asdict(cfg)}
        assert (cfg.n_params(), cfg.n_active_params()) == (rcfg.n_params(),
                                                           rcfg.n_active_params())
    full = registry.get_config(arch)
    assert {"mixtral-8x7b": (46_702_792_704, 12_879_925_248),
            "llama4-scout-17b-a16e": (101_730_063_360, 11_133_096_960)}[arch] == (
        full.n_params(), full.n_active_params())
    cfg, _, _, np_params, params = _weights(arch)
    fresh = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(np.shape, reference_tree(fresh)) == jax.tree.map(np.shape, np_params)
    assert sum(v.numel() for v in jax.tree.leaves(reference_tree(fresh))) == cfg.n_params()
    assert fresh["layers"]["router"].dtype == params["layers"]["router"].dtype == torch.float32
    with pytest.raises(ValueError, match="experts/top_k"):
        registry.override(cfg, n_experts=0)


def _reference_keep(ridx, rcfg):
    """The reference ``_dispatch``'s capacity mask, its own expressions."""
    G, Tg, k = ridx.shape
    C = max(1, int(rcfg.capacity_factor * Tg * k / rcfg.n_experts))
    onehot = jax.nn.one_hot(ridx.reshape(G, Tg * k), rcfg.n_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    return np.asarray(jnp.sum(pos * onehot, axis=-1) < C)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_keep_mask_and_dispatch_match_reference(arch, capacity_factor):
    cfg = registry.override(registry.get_smoke_config(arch), capacity_factor=capacity_factor)
    rcfg = dataclasses.replace(ref_registry.get_smoke_config(arch),
                               capacity_factor=capacity_factor)
    rlp, lp = _layer0(arch)
    x = _x(1, 2, 40, cfg.d_model)
    idx, gates, probs = moe.routing(lp, torch.from_numpy(x), cfg)
    ridx, rgates, rprobs = ref_moe._routing(rlp, jnp.asarray(x), rcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rgates), atol=MOE_ATOL, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), atol=MOE_ATOL, rtol=0)
    _, _, keep = moe.capacity_keep(idx, cfg)
    rkeep = _reference_keep(ridx, rcfg)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    assert capacity_factor > 1 or not rkeep.all()  # 0.5 drops
    stats = {}
    for impl in ("scatter", "dense"):
        y, aux = moe.moe_apply(lp, torch.from_numpy(x), cfg, impl=impl, stats=stats)
        ry, raux = ref_moe.moe_apply(rlp, jnp.asarray(x), rcfg, impl=impl)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=MOE_ATOL, rtol=0,
                                   err_msg=impl)
        np.testing.assert_allclose(aux.item(), float(raux), rtol=AUX_RTOL)
    assert int(stats["dropped"]) == int((~rkeep).sum()) and stats["routed"] == rkeep.size


@pytest.mark.parametrize("arch", ARCHS)
def test_scatter_equals_dense_where_nothing_drops(arch):
    cfg = registry.get_smoke_config(arch)
    cfg = registry.override(cfg, capacity_factor=cfg.n_experts / cfg.top_k)  # C = Tg
    _, lp = _layer0(arch)
    x = torch.from_numpy(_x(2, 3, 17, cfg.d_model))
    stats = {}
    ys, _ = moe.moe_apply(lp, x, cfg, impl="scatter", stats=stats)
    yd, _ = moe.moe_apply(lp, x, cfg, impl="dense")
    assert int(stats["dropped"]) == 0
    np.testing.assert_allclose(ys.numpy(), yd.numpy(), atol=MOE_ATOL, rtol=0)
    # a token a group (serving): the same function, nothing dropped
    tstats = {}
    yt = moe.moe_tokens(lp, x, cfg, tstats)
    np.testing.assert_allclose(yt.numpy(), yd.numpy(), atol=MOE_ATOL, rtol=0)
    assert int(tstats["dropped"]) == 0 and tstats["routed"] == x.shape[0] * 17 * cfg.top_k


@pytest.mark.parametrize("S", [16, 17])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_rule_matches_reference(arch, S):
    """moe_seq_chunk 8: S = 16 routes two groups of 8 a sequence, S = 17 one
    group of 17 (8 does not divide it); the drops differ and follow the
    reference's."""
    kw = dict(moe_seq_chunk=8, capacity_factor=0.5)
    cfg = registry.override(registry.get_smoke_config(arch), **kw)
    rcfg = dataclasses.replace(ref_registry.get_smoke_config(arch), **kw)
    rlp, lp = _layer0(arch)
    x = _x(3, 2, S, cfg.d_model)
    stats = {}
    y, _ = moe.moe_apply(lp, torch.from_numpy(x), cfg, stats=stats)
    ry, _ = ref_moe.moe_apply(rlp, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=MOE_ATOL, rtol=0)
    ridx, _, _ = ref_moe._routing(rlp, jnp.asarray(x), rcfg)
    groups = ridx.reshape(2, S // 8, 8, -1).reshape(-1, 8, cfg.top_k) if S == 16 else ridx
    assert int(stats["dropped"]) == int((~_reference_keep(groups, rcfg)).sum()) > 0


def _reference_slot_prefill(rcfg, rp, prompt, max_prompt, max_len, slots=3, slot=1):
    rprefill, _ = ref_serve.make_slot_prefill_step(rcfg, mesh(), max_prompt)
    padded = np.zeros(max_prompt, np.int32)
    padded[:prompt.shape[0]] = prompt
    return jax.jit(rprefill)(rp, jnp.asarray(padded), jnp.int32(prompt.shape[0]),
                             ref_tf.init_cache(rcfg, slots, max_len), jnp.int32(slot))


@pytest.mark.parametrize("plen", [5, 40])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_prefill_routes_a_token_a_group_as_the_reference_scan(arch, plen):
    """The admission's one forward (40 tokens: past mixtral's 32-token
    window) against the reference's decode step scanned over the prompt."""
    cfg, rcfg, rp, _, params = _weights(arch)
    max_prompt, max_len = 40, 48
    prompt = tokens(plen, (plen,), cfg.vocab)
    rlast, rcache = _reference_slot_prefill(rcfg, rp, prompt, max_prompt, max_len)
    cache = transformer.init_cache(cfg, 3, max_len, device="cpu")
    last = serve.make_slot_prefill_step(cfg, max_prompt)(params, as_long(prompt), cache, 1)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), **TOL)
    for n, leaf in cache.items():
        np.testing.assert_allclose(leaf[:, 1].numpy(), np.asarray(rcache[n])[:, 1], **TOL)
    stats = {}
    transformer.forward_prefill(params, as_long(prompt)[None], cfg, stats=stats)
    assert int(stats["dropped"]) == 0
    assert stats["routed"] == plen * cfg.top_k * cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_full_sequence_forward_drops_what_the_reference_drops(arch):
    _, _, rp, np_params, _ = _weights(arch)
    cfg = registry.override(registry.get_smoke_config(arch), capacity_factor=0.5)
    rcfg = dataclasses.replace(ref_registry.get_smoke_config(arch), capacity_factor=0.5)
    params = params_from_reference(np_params, cfg, device="cpu")
    toks = tokens(9, (2, 24), cfg.vocab)
    stats = {}
    ours = serve.make_prefill_step(cfg, device="cpu")(params, {"tokens": as_long(toks)},
                                                      stats=stats)
    rstep, _ = ref_serve.make_prefill_step(rcfg, mesh())
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax.jit(rstep)(rp, {
        "tokens": jnp.asarray(toks)})), **TOL)
    assert int(stats["dropped"]) > 0 and stats["routed"] == 2 * 24 * cfg.top_k * cfg.n_layers
    # the serving prefill of the same prompts drops nothing, so its logits differ
    served, _ = transformer.forward_prefill(params, as_long(toks), cfg)
    assert not torch.allclose(served, ours, atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_adds_the_aux_loss_as_the_reference(arch):
    cfg, rcfg, rp, _, params = _weights(arch)
    batch = {"tokens": tokens(10, (2, 16), cfg.vocab), "labels": tokens(11, (2, 16), cfg.vocab)}
    loss, metrics = transformer.forward_train(params, {k: as_long(v) for k, v in batch.items()},
                                              cfg)
    rloss, rmetrics = ref_tf.forward_train(rp, {k: jnp.asarray(v) for k, v in batch.items()},
                                           rcfg)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-6)
    np.testing.assert_allclose(metrics["aux_loss"].item(), float(rmetrics["aux_loss"]),
                               rtol=AUX_RTOL)
    np.testing.assert_allclose(metrics["loss"].item(), float(rmetrics["loss"]), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_prefill_and_24_decode_steps_match_reference(arch):
    """A 12-token prompt and 24 greedy steps: mixtral's 32-token window
    wraps."""
    cfg, rcfg, rp, _, params = _weights(arch)
    cached_decode(cfg, rcfg, rp, params, B=2, S=12, steps=24, atol=TOL["atol"])


@pytest.mark.parametrize("arch", ARCHS)
def test_24_paged_decode_steps_match_reference(arch):
    """32 positions (prompts of 8 and 5 tokens, 24 steps): within mixtral's
    window, so its cache pages."""
    cfg, rcfg, rp, _, params = _weights(arch)
    paged_decode_matches_reference(cfg, rcfg, rp, params, steps=24, atol=TOL["atol"], S=8,
                                   W=32)


def test_a_window_shorter_than_the_cache_is_not_pageable():
    cfg = registry.get_smoke_config("mixtral-8x7b")
    serve.validate_pageable(cfg, cfg.sliding_window)
    with pytest.raises(ValueError, match="not pageable"):
        serve.validate_pageable(cfg, cfg.sliding_window + 1)


@pytest.mark.parametrize("arch,workload", [("mixtral-8x7b", "llm_decode"),
                                           ("llama4-scout-17b-a16e", "llm_decode_paged")])
def test_engine_tokens_and_ticks_match_reference(arch, workload):
    _, _, rp, _, params = _weights(arch)
    kw = {"block_size": 8} if workload == "llm_decode_paged" else {}
    engine_matches_reference(arch, 3, rp, params, workload, **kw)


@pytest.mark.parametrize("arch,workload", [("mixtral-8x7b", "llm_decode"),
                                           ("llama4-scout-17b-a16e", "llm_decode_paged")])
def test_cli_serves_as_the_reference_cli(monkeypatch, arch, workload):
    eng = cli_matches_reference(monkeypatch, [
        "--arch", arch, "--smoke", "--continuous", "--workload", workload, "--dp", "3",
        "--slots", "3", "--requests", "6", "--prompt-len", "40", "--gen", "20"])
    assert eng.summary()["completed"] == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_on_the_moe_stack_matches_reference(arch):
    """An int8 cache (mixtral's: a rolling 32-token window, wrapped by 12 +
    24 positions): logits within 1e-5, int8 rows equal but for a rounding
    tie, scales within a relative 1e-5."""
    cfg, rcfg, rp, _, params = _weights(arch)
    cached_decode(dataclasses.replace(cfg, kv_cache_dtype="int8"),
                  dataclasses.replace(rcfg, kv_cache_dtype="int8"), rp, params, B=2, S=12,
                  steps=24, atol=1e-5)
