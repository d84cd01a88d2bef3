"""The event-script harness of the elastic tests (``tests/chaos.py``),
without JAX, so card tests can use it too.

The events, :class:`ChaosScript`, the headline training script and
:func:`oracle_replay` are the port's (``repro_torch.runtime.chaos``),
re-exported here.  This file adds the reference chaos suite's serving
traffic and script, and :func:`assert_params_bit_identical`, which holds
an elastic run to its oracle replay.
"""

from __future__ import annotations

import numpy as np

from repro_torch.runtime.chaos import (  # noqa: F401
    KILL_JOIN_TRAJECTORY,
    ChaosScript,
    Join,
    Kill,
    Stall,
    Unstall,
    kill_join_script,
    oracle_replay,
)


def poisson_arrivals(rng, n, mean_gap=3.0):
    """Arrival ticks with exponential gaps (a Poisson process)."""
    return np.floor(np.cumsum(rng.exponential(mean_gap, size=n))).astype(int)


def llm_requests(cls, vocab, n=8, seed=3):
    """The reference chaos suite's LLM traffic (``tests/test_chaos_serving.py``)."""
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(rng, n)
    lens = rng.integers(3, 9, size=n)
    max_new = rng.integers(4, 8, size=n)
    return [cls(id=i, arrival=int(arrivals[i]), prompt=rng.integers(0, vocab, size=int(lens[i])),
                max_new=int(max_new[i])) for i in range(n)]


def script():
    """The reference chaos suite's script: 4 -> 3 (a fail-stop kill) -> 5
    (two joiners) -> 4 (a second kill), a stall and unstall riding along
    (grow_on_join drains no straggler: the stall only exercises the
    heartbeats)."""
    return ChaosScript([
        Kill(step=4, device=2),
        Stall(step=8, device=1, factor=10.0),
        Join(step=14, devices=(4, 5)),
        Unstall(step=20, device=1),
        Kill(step=24, device=0),
    ])


TRAJECTORY = [("shrink", 4, 3), ("grow", 3, 5), ("shrink", 5, 4)]


def trajectory(resizes) -> list:
    return [(e.kind, e.old_dp, e.new_dp) for e in resizes]


def assert_params_bit_identical(a, b, context: str = ""):
    """Bitwise equality of two trees (nested dicts of tensors and host
    values): every float leaf equal value for value (``torch.equal``:
    ``-0.0 == 0.0``, as the reference's ``np.array_equal``), a bf16 leaf
    bit for bit, every other leaf equal."""
    import torch

    if isinstance(a, dict) or isinstance(b, dict):
        assert isinstance(a, dict) and isinstance(b, dict) and sorted(a) == sorted(b), (
            f"tree structures differ {context}: {sorted(a) if isinstance(a, dict) else a} "
            f"against {sorted(b) if isinstance(b, dict) else b}")
        for k in a:
            assert_params_bit_identical(a[k], b[k], f"{context}/{k}")
        return
    if not isinstance(a, torch.Tensor):
        assert a == b, f"{context}: {a} != {b}"
        return
    assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, (
        f"{context}: {a.dtype} {tuple(a.shape)} against {getattr(b, 'dtype', b)}")
    if a.dtype == torch.bfloat16:
        same = torch.equal(a.view(torch.int16), b.view(torch.int16))
    else:
        same = torch.equal(a, b)
    if not same:
        bad = float((a.double() - b.double()).abs().max())
        raise AssertionError(f"not bit-identical {context}: max abs diff {bad}")
