"""The port's selective scan against the reference's.

Same inputs, made with numpy from a seed, go through the port's plain
versions (``selective_scan_ref``, ``selective_scan_fused_ref``) and its
wrappers (which are the plain versions on the CPU), and through the
reference's oracle ``selective_scan_ref`` and its Pallas kernel in
interpret mode (as ``tests/test_kernel_selective_scan.py`` runs it).

Tolerances, as that file uses: fp32 atol = rtol = 1e-4 (summation order);
bf16 inputs 2e-2 (the same bf16 values on both sides; the reference's
kernel pads in bf16 and reduces in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.kernels.selective_scan.ops import selective_scan as ref_kernel  # noqa: E402
from repro.kernels.selective_scan.ref import selective_scan_ref as ref_oracle  # noqa: E402
from repro.models.ssm import _mamba1_ssm_inputs, mamba1_init  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.selective_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_fused_ref,
    selective_scan_ref,
)
from repro_torch.models import ssm  # noqa: E402

TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# (B, S, D, N, bd, chunk): the reference's kernel test shapes
SHAPES = [(1, 64, 16, 8, 16, 16), (2, 128, 32, 16, 16, 32), (1, 96, 64, 4, 32, 64)]


def _inputs(seed, B, S, D, N, dtype="float32"):
    """decay in (0, 1) (a well-conditioned recurrence, like exp(dt A)), bx ~
    0.1 N(0, 1), cs ~ N(0, 1), as numpy fp32 holding ``dtype`` values."""
    rng = np.random.default_rng(seed)
    decay = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D, N))))
    arrs = [decay, rng.standard_normal((B, S, D, N)) * 0.1, rng.standard_normal((B, S, N))]
    arrs = [a.astype(np.float32) for a in arrs]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in arrs]
    return arrs


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,D,N,bd,chunk", SHAPES)
def test_matches_reference_oracle_and_kernel(B, S, D, N, bd, chunk, dtype):
    arrs = _inputs(0, B, S, D, N, dtype)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    oracle_y, oracle_h = ref_oracle(*jx)
    kernel_y = ref_kernel(*jx, bd=bd, chunk=chunk, interpret=True)
    n0 = ss_ops.selective_scan.launches
    for y, h in (selective_scan_ref(*_torch(arrs, dtype)),
                 ss_ops.selective_scan(*_torch(arrs, dtype))):
        assert y.dtype == h.dtype == torch.float32
        assert y.shape == (B, S, D) and h.shape == (B, D, N)
        for theirs in (oracle_y, kernel_y):
            np.testing.assert_allclose(y.numpy(), np.asarray(theirs, np.float32), **TOL[dtype])
        np.testing.assert_allclose(h.numpy(), np.asarray(oracle_h), **TOL[dtype])
    assert ss_ops.selective_scan.launches == n0  # the CPU runs the plain version


@pytest.mark.parametrize("B,S,D,N", [(1, 64, 16, 8), (2, 33, 32, 16)])
def test_h0_carries_a_split_scan(B, S, D, N):
    """Two halves carried through h0 equal one scan over the whole sequence
    (the decode step is the scan at S = 1 from the carried state), and a
    nonzero h0 matches the reference oracle's."""
    decay, bx, cs = (torch.from_numpy(a) for a in _inputs(1, B, S, D, N))
    y, h = selective_scan_ref(decay, bx, cs)
    m = S // 2
    y1, h1 = ss_ops.selective_scan(decay[:, :m], bx[:, :m], cs[:, :m])
    y2, h2 = ss_ops.selective_scan(decay[:, m:], bx[:, m:], cs[:, m:], h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(h2, h, atol=1e-6, rtol=1e-6)
    h0 = np.random.default_rng(2).standard_normal((B, D, N)).astype(np.float32)
    oy, oh = ref_oracle(*(jnp.asarray(t.numpy()) for t in (decay, bx, cs)), h0=jnp.asarray(h0))
    y, h = selective_scan_ref(decay, bx, cs, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(oy), **TOL["float32"])
    np.testing.assert_allclose(h.numpy(), np.asarray(oh), **TOL["float32"])


@pytest.mark.parametrize("S", [1, 48])
def test_fused_plain_version_matches_model_inputs_and_oracle(S):
    """On the smoke config: the reference's ``_mamba1_ssm_inputs`` + its
    oracle against the port's fused plain version and fused wrapper fed
    the port's ``_ssm_inputs`` of the same weights and activations."""
    rcfg = ref_registry.get_smoke_config("falcon-mamba-7b")
    cfg = registry.get_smoke_config("falcon-mamba-7b")
    rp = mamba1_init(jax.random.PRNGKey(0), rcfg, jnp.float32)
    p = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in rp.items()}
    x1 = np.random.default_rng(S).standard_normal((2, S, cfg.d_inner)).astype(np.float32)
    h0 = (np.random.default_rng(3).standard_normal((2, cfg.d_inner, cfg.ssm_state)) * 0.5
          ).astype(np.float32)
    oy, oh = ref_oracle(*_mamba1_ssm_inputs(rp, jnp.asarray(x1), rcfg), h0=jnp.asarray(h0))
    dt, A, Bs, Cs = ssm._ssm_inputs(p, torch.from_numpy(x1), cfg)
    assert dt.dtype == A.dtype == torch.float32 and Bs.is_contiguous() and Cs.is_contiguous()
    for fn in (selective_scan_fused_ref, ss_ops.selective_scan_fused):
        y, h = fn(dt, torch.from_numpy(x1), A, Bs, Cs, h0=torch.from_numpy(h0))
        np.testing.assert_allclose(y.numpy(), np.asarray(oy), **TOL["float32"])
        np.testing.assert_allclose(h.numpy(), np.asarray(oh), **TOL["float32"])


def test_input_rules():
    """The shape, type and layout rules the wrappers enforce before a
    launch (they raise on the card; the CPU takes the plain version)."""
    decay, bx, cs = (torch.from_numpy(a) for a in _inputs(0, 2, 8, 16, 8))
    ss_ops.check_inputs(decay, bx, cs, torch.zeros(2, 16, 8))
    bad = [((decay, bx, cs[:, :, :4]), ValueError),          # cs's N
           ((decay[..., :2], bx[..., :2], cs[..., :2]), ValueError),  # N = 2
           ((decay, bx.bfloat16(), cs), TypeError),           # mixed types
           ((decay.half(), bx.half(), cs.half()), TypeError),
           ((decay.transpose(1, 2).contiguous().transpose(1, 2), bx, cs), ValueError),
           ((decay[:, :0], bx[:, :0], cs[:, :0]), ValueError)]  # S = 0
    for args, err in bad:
        with pytest.raises(err):
            ss_ops.check_inputs(*args)
    with pytest.raises(ValueError):
        ss_ops.check_inputs(decay, bx, cs, torch.zeros(2, 16, 4))
    dt = torch.rand(2, 8, 16)
    x, A, Bs = torch.randn(2, 8, 16), -torch.rand(16, 8), torch.randn(2, 8, 8)
    ss_ops.check_fused_inputs(dt, x, A, Bs, Bs)
    for args, err in [((dt, x, A[:, :4], Bs, Bs), ValueError),
                      ((dt.bfloat16(), x, A, Bs, Bs), TypeError),
                      ((dt, x.bfloat16(), A, Bs, Bs), TypeError),
                      ((dt, x, A, Bs.transpose(1, 2).contiguous().transpose(1, 2), Bs),
                       ValueError)]:
        with pytest.raises(err):
            ss_ops.check_fused_inputs(*args)


def test_fused_wrapper_updates_the_state_in_place():
    """``h_final=h0`` writes the final state over h0, and a batch where
    ``write_ok`` is False keeps its rows; y is the same either way."""
    rng = np.random.default_rng(7)
    B, S, D, N = 3, 5, 16, 8
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, S, D)) - 2.0)).astype(np.float32))
    x, Bs, Cs = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                 for sh in ((B, S, D), (B, S, N), (B, S, N)))
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(D, N).contiguous()
    h0 = torch.from_numpy(rng.standard_normal((B, D, N)).astype(np.float32))
    want_y, want_h = ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=h0)
    for write_ok in (None, torch.tensor([False, True, False])):
        state = h0.clone()
        y, h = ss_ops.selective_scan_fused(dt, x, A, Bs, Cs, h0=state, h_final=state,
                                           write_ok=write_ok)
        assert h is state
        torch.testing.assert_close(y, want_y, atol=0, rtol=0)
        keep = [] if write_ok is None else [0, 2]
        for b in range(B):
            torch.testing.assert_close(state[b], h0[b] if b in keep else want_h[b],
                                       atol=0, rtol=0)


def test_state_out_rules():
    """What the fused wrapper refuses as ``h_final`` and ``write_ok``."""
    B, S, D, N = 2, 3, 16, 8
    dt, x = torch.rand(B, S, D), torch.randn(B, S, D)
    A, Bs = -torch.rand(D, N), torch.randn(B, S, N)
    h0 = torch.zeros(B, D, N)
    flat = torch.zeros(2 * B * D * N)
    for h_final, write_ok in [
            (torch.zeros(B, D, 4), None),                        # shape
            (torch.zeros(B, D, N, dtype=torch.float64), None),   # type
            (torch.zeros(B, N, D).transpose(1, 2), None),        # layout
            (None, torch.ones(B + 1, dtype=torch.bool)),         # write_ok's shape
            (None, torch.ones(B, dtype=torch.uint8))]:           # write_ok's type
        with pytest.raises(ValueError):
            ss_ops.selective_scan_fused(dt, x, A, Bs, Bs, h0=h0, h_final=h_final,
                                        write_ok=write_ok)
    overlap = flat[:B * D * N].view(B, D, N), flat[D * N:D * N + B * D * N].view(B, D, N)
    with pytest.raises(ValueError):  # h_final partly over h0
        ss_ops.selective_scan_fused(dt, x, A, Bs, Bs, h0=overlap[0], h_final=overlap[1])


# --- the kernel's chunked instance (v3), modelled in plain torch ------------

from repro_torch.kernels.selective_scan.ref import selective_scan_lanes_ref  # noqa: E402


def _slow_decay_inputs(seed, B, S, D, N):
    """falcon-mamba's regime at init: dt ~ softplus(-4.6) ~ 0.01, A = -(1..N),
    so decays lie near 1 and long products of them matter; x, Bs, Cs ~
    N(0, 1), h0 ~ 0.5 N(0, 1).  Returns fp32 decay, bx, cs, h0 as the
    fused form forms them."""
    rng = np.random.default_rng(seed)
    dt = torch.from_numpy(np.log1p(np.exp(-4.6 + 0.1 * rng.standard_normal((B, S, D))))
                          .astype(np.float32))
    x, Bs, Cs = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                 for sh in ((B, S, D), (B, S, N), (B, S, N)))
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(D, N)
    h0 = torch.from_numpy((0.5 * rng.standard_normal((B, D, N))).astype(np.float32))
    return (dt[..., None] * A).exp(), (dt * x)[..., None] * Bs[:, :, None, :], Cs, h0


def _within_gate(out, ref):
    """The card's gate: |out - ref| <= 1e-5 + 1e-4 |ref| everywhere."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    bad = np.abs(out - ref) > 1e-5 + 1e-4 * np.abs(ref)
    assert not bad.any(), f"{bad.sum()} elements off, max abs err {np.abs(out - ref).max()}"


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("S", [1, 31, 257, 4097])
def test_lane_model_matches_plain_and_reference_oracle(S, N):
    decay, bx, cs, h0 = _slow_decay_inputs(S + N, 2, S, 4, N)
    y, h = selective_scan_lanes_ref(decay, bx, cs, h0)
    assert y.shape == (2, S, 4) and h.shape == (2, 4, N)
    py, ph = selective_scan_ref(decay, bx, cs, h0)
    oy, oh = ref_oracle(*(jnp.asarray(t.numpy()) for t in (decay, bx, cs)),
                        h0=jnp.asarray(h0.numpy()))
    for want_y, want_h in ((py.numpy(), ph.numpy()), (oy, oh)):
        _within_gate(y.numpy(), want_y)
        _within_gate(h.numpy(), want_h)


def test_lane_model_without_h0_and_in_bf16():
    """No h0 starts from zeros; bf16 inputs are widened to fp32 first."""
    decay, bx, cs, _ = _slow_decay_inputs(11, 1, 300, 8, 8)
    for args in ((decay, bx, cs), tuple(t.bfloat16() for t in (decay, bx, cs))):
        y, h = selective_scan_lanes_ref(*args)
        py, ph = selective_scan_ref(*args)
        _within_gate(y.numpy(), py.numpy())
        _within_gate(h.numpy(), ph.numpy())


@pytest.mark.parametrize("S, fused, want", [(1, True, "step"), (2, True, "chunked"),
                                            (32768, True, "chunked"), (1, False, "chunked"),
                                            (64, False, "chunked")])
def test_instance_is_chosen_from_the_form_and_S(S, fused, want):
    assert ss_ops.scan_instance(S, fused) == want
