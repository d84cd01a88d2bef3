"""The port's ``mrd_combine`` (plain version, and the wrapper on CPU
tensors) against the reference's ``mrd_combine_ref`` and its Pallas kernel
in interpret mode.

Tolerance: none against the reference's plain version.  Both dequantize
with one rounded fp32 product and add with one rounded fp32 sum, so fp32
outputs are equal bit for bit, and bf16 outputs (one round-to-nearest-even
cast of the same fp32 sum) too.  The reference's Pallas kernel in
interpret mode runs through XLA on the CPU, which contracts the product
and the sum into one fused multiply-add; it differs from both plain
versions by at most one fp32 ulp of the largest of the operands and the
result, and equals them exactly after the bf16 cast.
The CUDA kernel is held to the same plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mrd_combine.ops import mrd_combine as ref_kernel  # noqa: E402
from repro.kernels.mrd_combine.ref import mrd_combine_ref as ref_plain  # noqa: E402
from repro_torch.collectives import transforms  # noqa: E402
from repro_torch.kernels.mrd_combine import mrd_combine, mrd_combine_ref  # noqa: E402


def _inputs(seed, n, scale=1.0):
    """x, and (q, scales) from quantizing a second vector, with an
    all-zero 256-block (scale 1) when there are at least two blocks."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    g = (rng.standard_normal(n) * 5).astype(np.float32)
    if n >= 512:
        g[256:512] = 0.0
    q, s = transforms.quantize(torch.from_numpy(g))
    return x, q.numpy(), s.numpy()


def _ours(x, q, s, dtype, fn):
    return fn(torch.from_numpy(x).to(dtype), torch.from_numpy(q), torch.from_numpy(s))


@pytest.mark.parametrize("fn", [mrd_combine_ref, mrd_combine], ids=["plain", "wrapper"])
@pytest.mark.parametrize("n", [256, 1024, 3 * 512 * 3])
def test_fp32_equals_reference_bit_for_bit(fn, n):
    x, q, s = _inputs(n, n)
    ours = _ours(x, q, s, torch.float32, fn).numpy()
    np.testing.assert_array_equal(ours, np.asarray(ref_plain(jnp.asarray(x), q, s)))
    fused = np.asarray(ref_kernel(jnp.asarray(x), q, s, bn=256, interpret=True))
    deq = transforms.dequantize(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    ulp = np.spacing(np.maximum.reduce([np.abs(x), np.abs(deq), np.abs(ours)]))
    assert np.all(np.abs(ours - fused) <= ulp)


@pytest.mark.parametrize("fn", [mrd_combine_ref, mrd_combine], ids=["plain", "wrapper"])
def test_bf16_equals_reference_bit_for_bit(fn):
    n = 2048
    x, q, s = _inputs(7, n, scale=3.0)
    ours = _ours(x, q, s, torch.bfloat16, fn)
    assert ours.dtype == torch.bfloat16
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    for ref in (ref_plain(xb, q, s), ref_kernel(xb, q, s, bn=512, interpret=True)):
        np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


def test_wrapper_is_the_receive_math_of_the_int8_transform():
    """kernel(x, quantize(g)) == x + dequantize(quantize(g)), exactly."""
    x, q, s = _inputs(3, 1024)
    out = _ours(x, q, s, torch.float32, mrd_combine)
    want = torch.from_numpy(x) + transforms.dequantize(torch.from_numpy(q), torch.from_numpy(s))
    assert torch.equal(out, want)


@given(nblocks=st.integers(1, 8), seed=st.integers(0, 1000))
@settings(max_examples=20, deadline=None)
def test_combine_property(nblocks, seed):
    """Any block count: equal to the reference, and within the int8 bound
    |x + dequant(quantize(g)) - (x + g)| <= amax_block / 254 (+ fp32 slack)."""
    n = nblocks * 256
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10).astype(np.float32)
    g = (rng.standard_normal(n) * 5).astype(np.float32)
    q, s = transforms.quantize(torch.from_numpy(g))
    out = mrd_combine(torch.from_numpy(x), q, s).numpy()
    np.testing.assert_array_equal(out, np.asarray(ref_plain(jnp.asarray(x), q.numpy(), s.numpy())))
    bound = np.repeat(np.abs(g.reshape(-1, 256)).max(1), 256) / 254 + 1e-5
    assert np.all(np.abs(out - (x + g)) <= bound * 1.01)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, q, s = (torch.from_numpy(a) for a in _inputs(0, 512))
    with pytest.raises(ValueError):
        mrd_combine(x[:300], q[:300], s[:1])  # n % 256
    with pytest.raises(ValueError):
        mrd_combine(x, q, s[:1])  # scales do not match n
    with pytest.raises(TypeError):
        mrd_combine(x.double(), q, s)
    with pytest.raises(TypeError):
        mrd_combine(x, q.to(torch.int16), s)
    with pytest.raises(TypeError):
        mrd_combine(x, q, s.double())
    with pytest.raises(ValueError):
        mrd_combine(x, q, s.to("meta"))  # mixed devices
    assert mrd_combine.launches == 0  # the CPU path never launches the kernel
