"""The port's solvers against the reference's: each ``full_map`` on the
same inputs, batched over leading dimensions (the elementwise Poisson maps
bit for bit, the dense ones within rtol 1e-5, atol 1e-6: matrix products
sum in another order), the generated matrices bit for bit, and the
registry."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.asynchrony import solvers as ref_solvers  # noqa: E402
from repro_torch.asynchrony import solvers  # noqa: E402
from torch_async_ref import ATOL, RTOL, ref_rhs  # noqa: E402

CASES = {
    "poisson1d": (dict(n=60, shift=0.5, seed=0), dict(n=60, shift=0.5, rhs=ref_rhs(60)), True),
    "poisson1d-omega": (dict(n=60, omega=0.8, seed=2), dict(n=60, omega=0.8, rhs=ref_rhs(60, 2)),
                        True),
    "poisson2d": (dict(nx=10, ny=6, shift=0.5), dict(nx=10, ny=6, shift=0.5, rhs=ref_rhs(60)),
                  True),
    "jacobi_dense": (dict(n=60), dict(n=60), False),
    "richardson": (dict(n=60), dict(n=60), False),
    "d_iteration": (dict(n=60, damping=0.7), dict(n=60, damping=0.7), False),
}


def test_registry_matches_reference():
    assert set(solvers.SOLVERS) == set(ref_solvers.SOLVERS)
    with pytest.raises(ValueError, match="unknown solver"):
        solvers.get_solver("nope")


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_map_matches_reference_batched(case):
    ref_kw, kw, exact = CASES[case]
    name = case.split("-")[0]
    ref, ours = ref_solvers.make_solver(name, **ref_kw), solvers.make_solver(name, **kw)
    assert ours.n == ref.n and ours.contraction == ref.contraction
    x = np.random.default_rng(0).standard_normal((3, 4, ref.n)).astype(np.float32)
    want = np.asarray(jax.vmap(jax.vmap(ref.full_map))(jnp.asarray(x)))
    got = ours.full_map(torch.from_numpy(x)).numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the residual and the block update over the same leading dimensions
    np.testing.assert_allclose(ours.residual_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.vmap(jax.vmap(ref.residual_norm))(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    got = ours.block_views_update(torch.from_numpy(x)).numpy()  # 4 workers' views
    want = np.asarray(jax.vmap(ref.block_views_update)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_generated_matrices_are_the_references(seed):
    A, b = solvers.random_dd_system(40, seed=seed)
    rA, rb = ref_solvers.random_dd_system(40, seed=seed)
    np.testing.assert_array_equal(A, rA)
    np.testing.assert_array_equal(b, rb)
    assert solvers.spectral_radius_abs_T(A) == ref_solvers.spectral_radius_abs_T(rA)

    for name, keys in (("jacobi_dense", ("A", "b", "dinv")), ("richardson", ("A", "b")),
                       ("d_iteration", ("P", "v"))):
        ours = solvers.make_solver(name, n=40, seed=seed)
        # the reference's map closes over its arrays under the same names
        ref_fn = ref_solvers.make_solver(name, n=40, seed=seed).full_map
        ref = dict(zip(ref_fn.__code__.co_freevars,
                       (c.cell_contents for c in ref_fn.__closure__)))
        for k in keys:
            np.testing.assert_array_equal(ours.data[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_d_iteration_contraction_matches_damping():
    """The residual map is r -> damping * P r; P column-stochastic keeps
    the 1-norm of nonnegative vectors, so the residual's 1-norm contracts
    by exactly the damping each application."""
    fp = solvers.make_solver("d_iteration", n=32, damping=0.7)
    assert fp.contraction == 0.7
    x = torch.zeros(32)
    r0 = (fp.full_map(x) - x).abs().sum()
    y = fp.full_map(x)
    r1 = (fp.full_map(y) - y).abs().sum()
    np.testing.assert_allclose(float(r1), 0.7 * float(r0), rtol=1e-5)


def test_default_rhs_is_the_counter_source_and_moves_with_the_problem():
    """Without ``rhs=`` the Poisson solvers draw U[-10, 10] from the
    counter-based source: the same values for the same seed, another seed
    another right-hand side; ``to`` moves the data and keeps the map."""
    a = solvers.make_solver("poisson1d", n=64, seed=5)
    b = solvers.make_solver("poisson1d", n=64, seed=5)
    c = solvers.make_solver("poisson1d", n=64, seed=6)
    assert torch.equal(a.data["rhs"], b.data["rhs"])
    assert not torch.equal(a.data["rhs"], c.data["rhs"])
    assert a.data["rhs"].abs().max() <= 10.0 and a.data["rhs"].dtype == torch.float32
    x = torch.randn(2, 64)
    assert torch.equal(a.to("cpu").full_map(x), a.full_map(x))
