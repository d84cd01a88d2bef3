"""The differentiable scans of training against the reference's: mamba1's
chunked selective scan (``ssm.chunk_scan``, the reference's
``_chunk_scan``) with its gradients, at a ragged last chunk and at chunk 1,
and against the scan kernel's plain version (``selective_scan_fused_ref``);
mamba2's SSD scan (``ssm._ssd_scan``) gradients; and the mamba1 block's
training path (``mamba1_apply`` under autograd) against the reference's
block.

Tolerances (fp32; the Hillis-Steele scan combines in another order than
``lax.associative_scan``): y and the final state within 1e-5 + 1e-5 x
the largest magnitude; every gradient within 1e-5 + 1e-4 x its largest
magnitude.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.selective_scan.ref import selective_scan_fused_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

from torch_train_ref import one_thread  # noqa: E402,F401


def _close(ours, ref, rel, what):
    ref = np.asarray(ref)
    tol = 1e-5 + rel * float(np.abs(ref).max())
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0, atol=tol, err_msg=what)


def _mamba1_setup(seed):
    cfg = registry.get_smoke_config("falcon-mamba-7b")
    rcfg = ref_registry.get_smoke_config("falcon-mamba-7b")
    rp = ref_ssm.mamba1_init(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    rp = {k: np.array(v) for k, v in rp.items()}
    rp["dt_bias"] = (rp["dt_bias"] + rng.standard_normal(rp["dt_bias"].shape)).astype(np.float32)
    rp["A_log"] = (rp["A_log"] + 0.3 * rng.standard_normal(rp["A_log"].shape)).astype(np.float32)
    return cfg, rcfg, rp


SCAN_KEYS = ("x_proj", "dt_proj", "dt_bias", "A_log")


@pytest.mark.parametrize("S,chunk", [(37, 16), (32, 16), (9, 1), (5, 8)])
def test_chunk_scan_and_its_gradients_match_reference(S, chunk):
    """y of the reference's ``_chunk_scan`` and the gradients of a weighted
    sum of it with respect to x1 and the scan's parameters; the final
    state where the length is whole chunks (the reference's padded steps
    decay it further, which nothing downstream reads)."""
    cfg, rcfg, rp = _mamba1_setup(S)
    rng = np.random.default_rng(S + chunk)
    B, di = 2, cfg.d_inner
    x1 = rng.standard_normal((B, S, di)).astype(np.float32)
    w = rng.standard_normal((B, S, di)).astype(np.float32)
    h0 = np.zeros((B, di, cfg.ssm_state), np.float32)

    def ref_fn(p, x):
        y, h = ref_ssm._chunk_scan({**rp, **p}, x, rcfg, jnp.asarray(h0), chunk)
        return jnp.sum(y * w), (y, h)

    (_, (ry, rh)), (rg_p, rg_x) = jax.value_and_grad(ref_fn, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(rp[k]) for k in SCAN_KEYS}, jnp.asarray(x1))

    p = {k: torch.from_numpy(rp[k]).requires_grad_() for k in SCAN_KEYS}
    x = torch.from_numpy(x1).requires_grad_()
    dt, A, Bs, Cs = ssm._ssm_inputs(p, x, cfg)
    y, h = ssm.chunk_scan(dt, x, A, Bs, Cs, torch.from_numpy(h0), chunk)
    (y * torch.from_numpy(w)).sum().backward()
    _close(y.detach(), ry, 1e-5, "y")
    if S % chunk == 0:
        _close(h.detach(), rh, 1e-5, "h_final")
    _close(x.grad, rg_x, 1e-4, "dx1")
    for k in SCAN_KEYS:
        _close(p[k].grad, rg_p[k], 1e-4, k)
    # the kernel's plain version from the same inputs: y and the state at S
    fy, fh = selective_scan_fused_ref(*(t.detach() for t in (dt, x, A, Bs, Cs)))
    _close(y.detach(), fy, 1e-5, "y vs selective_scan_fused_ref")
    _close(h.detach(), fh, 1e-5, "h vs selective_scan_fused_ref")


def test_chunk_scan_from_a_state_and_its_state_gradient():
    """From a nonzero h0 the state's gradient is the adjoint carried back
    through every chunk: against autograd of the plain step-by-step scan."""
    torch.manual_seed(0)
    B, S, di, N = 2, 11, 6, 4
    dt = (torch.rand(B, S, di) * 0.5).requires_grad_()
    x = torch.randn(B, S, di, requires_grad=True)
    A = (-torch.rand(di, N) * 4).requires_grad_()
    Bs, Cs = torch.randn(B, S, N, requires_grad=True), torch.randn(B, S, N, requires_grad=True)
    h0 = torch.randn(B, di, N, requires_grad=True)
    w = torch.randn(B, S, di)
    ins = (dt, x, A, Bs, Cs, h0)
    y, h = ssm.chunk_scan(dt, x, A, Bs, Cs, h0, 4)
    g = torch.autograd.grad((y * w).sum() + h.sum(), ins)
    ry, rh = selective_scan_fused_ref(dt, x, A, Bs, Cs, h0)
    rg = torch.autograd.grad((ry * w).sum() + rh.sum(), ins)
    _close(y.detach(), ry.detach(), 1e-5, "y")
    _close(h.detach(), rh.detach(), 1e-5, "h")
    for name, a, b in zip(("dt", "x", "A", "Bs", "Cs", "h0"), g, rg):
        _close(a, b, 1e-4, name)


def test_mamba1_block_trains_through_the_chunked_scan():
    """``mamba1_apply`` under autograd (the chunked scan, the reference's
    chunk of 256 cut to S) against the reference's block: output and the
    gradients of every parameter."""
    cfg, rcfg, rp = _mamba1_setup(4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    ry, rg = jax.value_and_grad(
        lambda p: jnp.sum(ref_ssm.mamba1_apply(p, jnp.asarray(x), rcfg) * w))(
        {k: jnp.asarray(v) for k, v in rp.items()})
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in rp.items()}
    out, _ = ssm.mamba1_apply(p, torch.from_numpy(x), cfg)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ry), rtol=1e-5)
    for k in rp:
        _close(p[k].grad, rg[k], 1e-4, k)


@pytest.mark.parametrize("S,chunk", [(37, 16), (8, 8)])
def test_ssd_scan_gradients_match_reference(S, chunk):
    """mamba2's SSD scan differentiates (no in-place write on a tensor
    autograd saved): gradients of a weighted sum of y and the final state
    with respect to every input, against the reference's."""
    B, nh, hp, st = 2, 3, 4, 5
    rng = np.random.default_rng(S)
    xh = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    Bs, Cs = (rng.standard_normal((B, S, st)).astype(np.float32) for _ in range(2))
    dt = np.log1p(np.exp(rng.uniform(-3, 0, (B, S, nh)))).astype(np.float32)
    A = -rng.uniform(0.5, 4, nh).astype(np.float32)
    h0 = (rng.standard_normal((B, nh, hp, st)) * 0.5).astype(np.float32)
    w = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    ins = (xh, Bs, Cs, dt, A, h0)

    def ref_fn(*a):
        y, h = ref_ssm._ssd_scan(*a, chunk)
        return jnp.sum(y * w) + jnp.sum(h)

    rg = jax.grad(ref_fn, argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h = ssm._ssd_scan(*ts, chunk)
    ((y * torch.from_numpy(w)).sum() + h.sum()).backward()
    for name, t, r in zip(("xh", "Bs", "Cs", "dt", "A", "h0"), ts, rg):
        _close(t.grad, r, 1e-4, name)
