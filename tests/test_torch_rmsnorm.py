"""The port's rmsnorm against the reference's.

Same inputs, made with numpy from a seed, go through the port's
``rmsnorm_ref`` and ``models.layers.rmsnorm`` (the kernel wrapper, which
is the plain version on the CPU) and through the reference's
``rmsnorm_ref``, its Pallas kernel in interpret mode (as
``tests/test_kernel_mrd_combine_rmsnorm.py`` runs it) and its
``models.layers.rmsnorm``.

Tolerances: fp32 atol = rtol = 1e-5 (summation order of the sum of
squares); bf16 2e-2 (one bf16 rounding of the output).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm.ops import rmsnorm as ref_kernel  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as ref_oracle  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _inputs(T, d, dtype, seed=0):
    """x ~ 3 N(0, 1) in ``dtype`` (the same bf16 values on both sides), w ~
    0.1 N(0, 1) in fp32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, d)) * 3).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return x, (rng.standard_normal(d) * 0.1).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d", [(64, 128), (100, 256), (16, 512), (4, 3840)])
def test_matches_reference_oracle_and_kernel(T, d, dtype):
    x, w = _inputs(T, d, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    n0 = rn_ops.rmsnorm.launches
    for ours in (rmsnorm_ref(tx, torch.from_numpy(w)),
                 layers.rmsnorm(tx, torch.from_numpy(w))):
        assert ours.dtype == tx.dtype and ours.shape == tx.shape
        for theirs in (ref_oracle(jx, jnp.asarray(w)),
                       ref_kernel(jx, jnp.asarray(w), bt=32, interpret=True)):
            np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32),
                                       **TOL[dtype])
    assert rn_ops.rmsnorm.launches == n0  # the CPU runs the plain version


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_model_layer_matches_reference_layer(eps):
    """[..., d] inputs (the model's [B, S, d] and [B, d]) are flattened to
    the kernel's [T, d] rows and back; bf16 weights as the model keeps them."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 4, 64)).astype(np.float32)
    w = np.full((64,), 0.05, np.float32)
    ours = layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w).bfloat16(), eps)
    theirs = ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16), eps)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL["float32"])
    col = layers.rmsnorm(torch.from_numpy(x)[:, -1], torch.from_numpy(w).bfloat16(),
                         eps)  # strided rows
    np.testing.assert_allclose(col.numpy(), np.asarray(theirs)[:, -1], **TOL["float32"])


def test_training_takes_the_plain_version_with_its_gradient():
    """Under autograd the layer runs the plain version (the kernel has no
    backward), so the gradient is the plain version's."""
    x, w = _inputs(6, 64, "float32", seed=3)
    grads = []
    for fn in (layers.rmsnorm, rmsnorm_ref):
        tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
        fn(tx, tw).square().sum().backward()
        grads.append((tx.grad.numpy(), tw.grad.numpy()))
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)
