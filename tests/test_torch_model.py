"""The port's dense decoder against the reference's, on the smoke
``llama3.2-1b`` in fp32 with the reference's weights carried across by
``repro_torch.models.convert``.

Tolerance: atol = rtol = 1e-5 on fp32 logits and cache pages (the two
sides sum in different orders; the kernel path's attention is the plain
version here, and the reference's is its Pallas kernel in interpret mode).
"""

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
from repro_torch.models.convert import params_from_reference  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
BS, NB, SLOTS = 8, 3, 4  # block size, blocks per slot, slots
MAX_LEN = BS * NB


@pytest.fixture(scope="module")
def setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = registry.get_smoke_config("llama3.2-1b")
    rcfg = ref_registry.get_smoke_config("llama3.2-1b")
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    mesh = compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))
    return cfg, rcfg, params, rparams, mesh


def _state(seed, cfg, *, lengths=(0, 5, 12, 23)):
    """Random pages, a disjoint table per slot, lengths incl. 0 and full-1."""
    rng = np.random.default_rng(seed)
    N = SLOTS * NB + 1
    shape = (cfg.n_layers, N, BS, cfg.n_kv_heads, cfg.head_dim)
    pages = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    tables = rng.permutation(np.arange(1, N)).reshape(SLOTS, NB).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab, size=SLOTS).astype(np.int32)
    return pages, tables, np.asarray(lengths, np.int32), tokens


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def test_converted_params_match_port_layout(setup):
    cfg, rcfg, params, _, _ = setup
    fresh = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh["layers"].items()} == {
        k: tuple(v.shape) for k, v in params["layers"].items()}
    n = sum(v.numel() for v in fresh["layers"].values()) + fresh["embed"].numel() + cfg.d_model
    assert n == cfg.n_params() == rcfg.n_params()


@pytest.mark.parametrize("write_ok", [None, (True, False, True, True)])
def test_forward_decode_paged_matches_reference(setup, write_ok):
    cfg, rcfg, params, rparams, _ = setup
    pages, tables, lengths, tokens = _state(1, cfg)
    ok = None if write_ok is None else np.asarray(write_ok)
    tpages = {n: _t(v) for n, v in pages.items()}
    logits, tpages, _ = transformer.forward_decode_paged(
        params, _t(tokens, torch.long), tpages, _t(tables), _t(lengths), cfg,
        block_size=BS, write_ok=None if ok is None else _t(ok))
    rlogits, rpages, _ = ref_tf.forward_decode_paged(
        rparams, jnp.asarray(tokens), {n: jnp.asarray(v) for n, v in pages.items()},
        jnp.asarray(tables), {}, jnp.asarray(lengths), rcfg, block_size=BS,
        write_ok=None if ok is None else jnp.asarray(ok))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpages[n].numpy(), np.asarray(rpages[n]), **TOL)


def test_gather_step_matches_reference_and_kernel_path(setup):
    cfg, rcfg, params, rparams, mesh = setup
    pages, tables, lengths, tokens = _state(2, cfg)
    ok = np.array([True, True, False, True])
    step = serve.make_paged_pool_decode_step(cfg, BS, attn="gather")
    tpages = {n: _t(v) for n, v in pages.items()}
    logits = step(params, _t(tokens, torch.long), tpages, _t(tables), _t(lengths), _t(ok))
    rstep, _ = ref_serve.make_paged_pool_decode_step(rcfg, mesh, BS, attn="gather")
    rlogits, rpages, _ = rstep(
        rparams, jnp.asarray(tokens), {n: jnp.asarray(v) for n, v in pages.items()},
        jnp.asarray(tables), {}, jnp.asarray(lengths), jnp.asarray(ok))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpages[n].numpy(), np.asarray(rpages[n]), **TOL)
    kpages = {n: _t(v) for n, v in pages.items()}
    kstep = serve.make_paged_pool_decode_step(cfg, BS, attn="kernel")
    klogits = kstep(params, _t(tokens, torch.long), kpages, _t(tables), _t(lengths), _t(ok))
    # an inactive slot's own new row goes to the trash block on the kernel
    # path, so only active slots' logits are comparable (both discard it)
    # (and its later layers' trash-block rows differ for the same reason)
    np.testing.assert_allclose(klogits[ok].numpy(), logits[ok].numpy(), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(kpages[n][:, 1:].numpy(), tpages[n][:, 1:].numpy(), **TOL)


@pytest.mark.parametrize("plen,shared", [(13, 0), (1, 0), (16, 1)])
def test_slot_prefill_matches_reference(setup, plen, shared):
    """Last logits and written pages after a paged admission; ``shared``
    leading blocks are skip-written (a prefix another request owns)."""
    cfg, rcfg, params, rparams, mesh = setup
    max_prompt = 16
    pages, tables, _, _ = _state(3, cfg)
    rng = np.random.default_rng(plen)
    prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
    slot, row = 2, np.array([5, 9, 1], np.int32)
    mask = np.arange(NB) >= shared
    prefill = serve.make_paged_slot_prefill_step(cfg, max_prompt, MAX_LEN, BS)
    tpages, ttables = {n: _t(v) for n, v in pages.items()}, _t(tables)
    last = prefill(params, _t(prompt, torch.long), tpages, ttables, slot, _t(row), _t(mask))
    rprefill, _ = ref_serve.make_paged_slot_prefill_step(rcfg, mesh, max_prompt, MAX_LEN, BS)
    padded = np.zeros(max_prompt, np.int32)
    padded[:plen] = prompt
    rlast, rpages, rtables, _ = jax.jit(rprefill)(
        rparams, jnp.asarray(padded), jnp.int32(plen),
        {n: jnp.asarray(v) for n, v in pages.items()}, jnp.asarray(tables), {},
        jnp.int32(slot), jnp.asarray(row), jnp.asarray(mask))
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), **TOL)
    np.testing.assert_array_equal(ttables.numpy(), np.asarray(rtables))
    live = [b for b, m in zip(row, mask) if m]  # the trash block 0 is garbage
    for n in ("k", "v"):
        np.testing.assert_allclose(tpages[n][:, live].numpy(), np.asarray(rpages[n])[:, live],
                                   **TOL)
        untouched = np.setdiff1d(np.arange(1, SLOTS * NB + 1), live)
        np.testing.assert_array_equal(tpages[n][:, untouched].numpy(), pages[n][:, untouched])


def test_contiguous_decode_matches_prefill(setup):
    """Decoding a prompt token by token through the contiguous cache gives
    the causal prefill's last logits and K/V rows (the port's two
    attention paths agree with each other)."""
    cfg, _, params, _, _ = setup
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 7)))
    last, rows = transformer.forward_prefill(params, prompt, cfg)
    k, v = rows["k"], rows["v"]
    cache = transformer.init_cache(cfg, 2, 8, device="cpu")
    for i in range(7):
        logits, cache = transformer.forward_decode(
            params, prompt[:, i], cache, torch.full((2,), i), cfg)
    np.testing.assert_allclose(logits.numpy(), last.numpy(), **TOL)
    np.testing.assert_allclose(cache["k"][:, :, :7].numpy(), k.numpy(), **TOL)
    np.testing.assert_allclose(cache["v"][:, :, :7].numpy(), v.numpy(), **TOL)
