"""The port's engine against the reference's ``run()`` on the paper's
problem (poisson1d, n = 120, shift 0.5, eps 1e-5, max_delay 2, activity
0.7, seed 1), every detection protocol at p = 3, 4 and 5, with the
reference's trace delays and marker delays fed to the port.

``detected``, ``ticks``, ``kiter`` and both message counts are equal;
``x``, ``res_glb`` and ``true_res`` within rtol 1e-5, atol 1e-6
(``torch_async_ref``).  The reference's ``sweep()`` is not the yardstick:
it is not bit-identical to its own ``run()`` on this JAX.
"""

import pytest

torch = pytest.importorskip("torch")

from repro import asynchrony as R  # noqa: E402
from repro_torch import asynchrony as A  # noqa: E402
from torch_async_ref import assert_same_run, paired_run, ref_rhs  # noqa: E402

N = 120


@pytest.fixture(scope="module")
def problems():
    return (R.make_solver("poisson1d", n=N, shift=0.5, seed=0),
            A.make_solver("poisson1d", n=N, shift=0.5, rhs=ref_rhs(N)))


@pytest.mark.parametrize("p", [3, 4, 5])
@pytest.mark.parametrize("protocol", ["inexact", "exact", "interval", "oracle", "sync"])
def test_engine_matches_reference_run(problems, protocol, p):
    ref, port = paired_run(*problems, p=p, detection=protocol)
    assert_same_run(ref, port)
