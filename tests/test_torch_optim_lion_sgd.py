"""The port's Lion and SGD against the reference's, in the vector form
(the ZeRO-1 shards) and the tree form (``mrd_leaf``/``local_sgd``), on the
same numpy inputs in fp32.

Tolerance: within 1e-6 relative (and 1e-8 absolute, for coordinates at
zero).  Both sides run the same fp32 operations; the learning rate is the
same fp32 value (``test_torch_optim.py``).  Lion's ``sign`` is exact away
from 0; the inputs keep ``beta1 * mu + (1 - beta1) * g`` away from 0, so
no coordinate sits on the tie that would move it by 2 x lr.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizer as ref_opt  # noqa: E402
from repro_torch.optim import optimizer as opt  # noqa: E402

KW = dict(warmup_steps=10, total_steps=100, lr=3e-3)


def _inputs(seed: int, n: int = 2048):
    rng = np.random.default_rng(seed)
    g, m, mu = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    nu = np.abs(rng.standard_normal(n)).astype(np.float32)
    # keep Lion's sign argument off its tie at 0
    arg = 0.9 * mu + 0.1 * g
    g = np.where(np.abs(arg) < 1e-3, g + np.float32(0.05), g).astype(np.float32)
    return g, m, mu, nu


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", ["lion", "sgd"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
@pytest.mark.parametrize("step", [0, 4, 50])
def test_vector_form_matches_reference(name, weight_decay, step):
    g, m, mu, nu = _inputs(step)
    kw = dict(KW, name=name, weight_decay=weight_decay)
    t = {"master": torch.from_numpy(m), "mu": torch.from_numpy(mu), "nu": torch.from_numpy(nu)}
    new_m, new = opt.apply_update_vector(torch.from_numpy(g), t, opt.OptimizerConfig(**kw), step)
    rnew_m, rnew = ref_opt.apply_update_vector(
        jnp.asarray(g), {"master": jnp.asarray(m), "mu": jnp.asarray(mu), "nu": jnp.asarray(nu)},
        ref_opt.OptimizerConfig(**kw), jnp.int32(step))
    _close(new_m.numpy(), rnew_m)
    for k in ("master", "mu", "nu"):
        _close(new[k].numpy(), rnew[k])
    # the moments an optimizer does not use are passed through, untouched
    assert new["nu"] is t["nu"]
    if name == "sgd":
        assert new["mu"] is t["mu"]


@pytest.mark.parametrize("name", ["lion", "sgd"])
@pytest.mark.parametrize("step", [0, 7])
def test_tree_form_matches_reference(name, step):
    shapes = {"a": (37,), "b": (5, 64), "c": (3, 2, 17)}
    leaves = {k: _inputs(step + i, int(np.prod(s))) for i, (k, s) in enumerate(shapes.items())}
    grads = {k: v[0].reshape(shapes[k]) for k, v in leaves.items()}
    state = {part: {k: v[j].reshape(shapes[k]) for k, v in leaves.items()}
             for j, part in enumerate(("master", "mu", "nu"), start=1)}
    ocfg = opt.OptimizerConfig(name=name, **KW)
    names = sorted(shapes)  # the reference's flatten order
    port_opt = {part: [torch.from_numpy(state[part][k].copy()) for k in names]
                for part in state}
    params = opt.apply_update_tree_([torch.from_numpy(grads[k]) for k in names], port_opt, ocfg,
                                    step, torch.bfloat16)
    rparams, ropt = ref_opt.apply_update(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, state),
        ref_opt.OptimizerConfig(name=name, **KW), jnp.int32(step), jnp.bfloat16)
    for i, k in enumerate(names):
        for part in ("master", "mu", "nu"):
            _close(port_opt[part][i].numpy(), ropt[part][k])
        assert params[i].dtype == torch.bfloat16
        np.testing.assert_array_equal(params[i].float().numpy(),
                                      np.asarray(rparams[k].astype(jnp.float32)))


def test_unknown_optimizer_is_refused():
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.apply_update_vector(z, {"master": z, "mu": z, "nu": z},
                                opt.OptimizerConfig(name="adam"), 0)
