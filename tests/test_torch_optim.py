"""The port's learning-rate schedules and vector-form optimizers against
the reference's.

Tolerance: the learning rate is equal as an fp32 value (both compute it
in fp32 from the same operations).  The updated shards agree within
2 fp32 ulps (atol 1e-7 at these magnitudes): ``beta ** t`` is a
library ``pow`` on each side, and may differ in its last bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizer as ref_opt  # noqa: E402
from repro_torch.optim import optimizer as opt  # noqa: E402


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_schedule_lr_matches_reference(schedule, warmup):
    kw = dict(schedule=schedule, warmup_steps=warmup, total_steps=100, lr=3e-3)
    ours, ref = opt.OptimizerConfig(**kw), ref_opt.OptimizerConfig(**kw)
    for step in (0, 1, 5, 10, 11, 57, 89, 90, 95, 99, 100, 150):
        assert np.float32(opt.schedule_lr(ours, step)) == np.float32(
            ref_opt.schedule_lr(ref, jnp.int32(step))), step


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
@pytest.mark.parametrize("step", [0, 4, 50])
def test_apply_update_vector_matches_reference(weight_decay, step):
    rng = np.random.default_rng(step)
    g, m, mu = (rng.standard_normal(2048).astype(np.float32) for _ in range(3))
    nu = np.abs(rng.standard_normal(2048)).astype(np.float32)
    kw = dict(warmup_steps=10, total_steps=100, lr=3e-3, weight_decay=weight_decay)
    new_m, new = opt.apply_update_vector(
        torch.from_numpy(g), {"master": torch.from_numpy(m), "mu": torch.from_numpy(mu),
                              "nu": torch.from_numpy(nu)}, opt.OptimizerConfig(**kw), step)
    rnew_m, rnew = ref_opt.apply_update_vector(
        jnp.asarray(g), {"master": jnp.asarray(m), "mu": jnp.asarray(mu), "nu": jnp.asarray(nu)},
        ref_opt.OptimizerConfig(name="adamw", **kw), jnp.int32(step))
    np.testing.assert_allclose(new_m.numpy(), np.asarray(rnew_m), atol=1e-7, rtol=0)
    for k in ("master", "mu", "nu"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(rnew[k]), atol=1e-7, rtol=0)


def test_init_opt_vector():
    v = opt.init_opt_vector(512)
    r = ref_opt.init_opt_vector(512)
    assert set(v) == set(r)
    for k in v:
        assert v[k].dtype == torch.float32 and v[k].shape == (512,) and not v[k].any()
