"""The reference's draws, handed to the port as inputs: what the engine
parity tests share.

torch cannot reproduce ``jax.random``, so a parity run feeds the port the
reference's randomness: the delays through the ``trace`` model (the
reference's ``record_trace``), the snapshot's marker delays through a
``TableSource`` computed with the reference's key chain, and the
right-hand sides the reference draws.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import asynchrony as R
from repro.asynchrony import delay_models as RD
from repro_torch import asynchrony as A
from repro_torch.asynchrony.draws import TableSource

# floats against the reference: the integers are held exactly
RTOL, ATOL = 1e-5, 1e-6
BASE = dict(delay_model="trace", max_delay=2, activity=0.7, seed=1, eps=1e-5, max_ticks=50000)


def marker_tables(seed: int, ticks: int, p: int, max_delay: int):
    """The reference engine's snapshot draws for ticks ``0..ticks-1``:
    ``k = split(fold_in(PRNGKey(seed), tick))[1]``, markers ``randint(k,
    (p,))``, reply ``randint(fold_in(k, 1), ())``."""

    def one(t):
        k = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), t))[1]
        return (jax.random.randint(k, (p,), 0, max_delay + 1),
                jax.random.randint(jax.random.fold_in(k, 1), (), 0, max_delay + 1))

    d, r = jax.jit(jax.vmap(one))(jnp.arange(ticks))
    return np.asarray(d), np.asarray(r)


def ref_rhs(n: int, seed: int = 0, scale: float = 10.0) -> np.ndarray:
    """The right-hand side the reference's Poisson solvers draw."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,), minval=-scale,
                                         maxval=scale))


def to_torch(trace) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in trace.items()}


def paired_run(ref_fp, port_fp, **cfg):
    """The reference's ``run()`` under trace delays, and the port's on the
    CPU with the same trace and the reference's marker delays."""
    cfg = {**BASE, **cfg}
    rcfg = R.AsyncConfig(**cfg)
    trace = RD.record_trace(rcfg, rcfg.p, ticks=256)
    ref = R.run(ref_fp, rcfg, delay_params=trace)
    d, reply = marker_tables(rcfg.seed, ref.ticks + 64, rcfg.p, rcfg.max_delay)
    port = A.run(port_fp, A.AsyncConfig(**cfg), delay_params=to_torch(trace),
                 source=TableSource(d, reply), device="cpu")
    return ref, port


def assert_same_run(ref, port):
    assert ref.detected and port.detected == ref.detected
    assert port.ticks == ref.ticks
    np.testing.assert_array_equal(port.kiter, ref.kiter)
    assert port.messages_p2p == ref.messages_p2p
    assert port.messages_coll == ref.messages_coll
    np.testing.assert_allclose(port.x, ref.x, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.res_glb, ref.res_glb, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.true_res, ref.true_res, rtol=RTOL, atol=ATOL)
