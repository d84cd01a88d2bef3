"""The port's engine against the reference's ``run()`` on the other
solvers (``exact`` at p = 5) and at p = 7, where MRD's backward and
forward shifts carry three extra ranks (``exact`` and ``inexact``, n =
126).  Same inputs and tolerances as ``test_torch_async_parity``."""

import pytest

torch = pytest.importorskip("torch")

from repro import asynchrony as R  # noqa: E402
from repro_torch import asynchrony as A  # noqa: E402
from torch_async_ref import assert_same_run, paired_run, ref_rhs  # noqa: E402

SOLVERS = {
    "poisson2d": (dict(nx=10, ny=6, shift=0.5), dict(nx=10, ny=6, shift=0.5, rhs=ref_rhs(60)), {}),
    "jacobi_dense": (dict(n=60), dict(n=60), {}),
    "richardson": (dict(n=60), dict(n=60), {}),
    "d_iteration": (dict(n=60), dict(n=60), dict(eps=1e-7)),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_exact_matches_reference_on_every_solver(name):
    ref_kw, port_kw, cfg = SOLVERS[name]
    ref, port = paired_run(R.make_solver(name, **ref_kw), A.make_solver(name, **port_kw),
                           p=5, detection="exact", **cfg)
    assert_same_run(ref, port)


@pytest.mark.parametrize("protocol", ["exact", "inexact"])
def test_engine_matches_reference_at_p7(protocol):
    ref, port = paired_run(R.make_solver("poisson1d", n=126, shift=0.5, seed=0),
                           A.make_solver("poisson1d", n=126, shift=0.5, rhs=ref_rhs(126)),
                           p=7, detection=protocol)
    assert_same_run(ref, port)
