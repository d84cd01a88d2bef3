"""The detection protocols' engine half and the snapshot against the
reference's, tick by tick, on identical inputs: both sides see the same
iterates, update magnitudes and ticks, and the port's marker delays are
the reference's (computed from its key chain).  Every state leaf and the
messages billed are compared each tick: integers and flags exactly,
floats within rtol 1e-5, atol 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import asynchrony as R  # noqa: E402
from repro.asynchrony import protocols as ref_protocols  # noqa: E402
from repro.asynchrony.engine import _stage_message_table  # noqa: E402
from repro.core import snapshot as ref_snapshot  # noqa: E402
from repro_torch import asynchrony as A  # noqa: E402
from repro_torch.asynchrony import protocols  # noqa: E402
from repro_torch.asynchrony.draws import Draw, TableSource  # noqa: E402
from repro_torch.collectives import schedules  # noqa: E402
from repro_torch.core import snapshot  # noqa: E402
from torch_async_ref import ATOL, RTOL, marker_tables, ref_rhs  # noqa: E402

SEED, D, TICKS = 3, 2, 48


def _assert_tree(ours, ref, where=""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), where
        for k in ref:
            _assert_tree(ours[k], ref[k], f"{where}/{k}")
        return
    ours = ours.numpy()[0]  # the port's one lane
    ref = np.asarray(ref)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL, err_msg=where)
    else:
        np.testing.assert_array_equal(ours, ref, err_msg=where)


def test_snapshot_matches_reference_tick_by_tick():
    """Snapshots start, latch and complete at the same ticks with the same
    blocks; a new one starts as soon as the last is done."""
    p, m = 5, 3
    d, reply = marker_tables(SEED, TICKS + 1, p, D)
    rng = np.random.default_rng(0)
    ref, ours = ref_snapshot.init(p, m), snapshot.init(p, m, (1,))
    for t in range(1, TICKS + 1):
        x = rng.standard_normal((p, m)).astype(np.float32)
        now = torch.tensor([t], dtype=torch.int32)
        if not bool(ref["in_progress"]):
            key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), t))[1]
            ref = ref_snapshot.start(ref, jnp.int32(t), key, D)
            ours = snapshot.start(ours, now, torch.tensor(d[t][None]),
                                  torch.tensor(reply[t][None]))
        ref = ref_snapshot.tick(ref, jnp.asarray(x), jnp.int32(t))
        ours = snapshot.tick(ours, torch.from_numpy(x)[None], now)
        _assert_tree(ours, ref, f"tick {t}")
        fin = bool(ref_snapshot.done(ref, jnp.int32(t)))
        assert snapshot.done(ours, now).tolist() == [fin]
        np.testing.assert_array_equal(snapshot.assembled(ours)[0].numpy(),
                                      np.asarray(ref_snapshot.assembled(ref)))
        if fin:
            ref = {**ref, "in_progress": jnp.zeros((), jnp.bool_)}
            ours = {**ours, "in_progress": torch.zeros(1, dtype=torch.bool)}


def _fixed_point(p, m):
    """poisson1d (shift 0.5) on both sides and its fp32 solution."""
    n = p * m
    rhs = ref_rhs(n)
    A_ = np.diag(np.full(n, 2.5)) - np.eye(n, k=1) - np.eye(n, k=-1)
    return (R.make_solver("poisson1d", n=n, shift=0.5, seed=0),
            A.make_solver("poisson1d", n=n, shift=0.5, rhs=rhs),
            np.linalg.solve(A_, rhs.astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("name", ["inexact", "exact", "interval", "oracle", "sync"])
def test_protocol_tick_matches_reference(name, p):
    """Iterates that close in on the fixed point, so each protocol
    certifies within the run: the same state, certification tick and
    messages on both sides, every tick."""
    m, eps = 4, 1e-4
    ref_fp, fp, xstar = _fixed_point(p, m)
    cfg = A.AsyncConfig(p=p, max_delay=D, detection=name)
    ref_cfg = R.AsyncConfig(p=p, max_delay=D, detection=name)
    ref_proto, proto = ref_protocols.get_protocol(name), protocols.get_protocol(name)
    msg_table = _stage_message_table(p)
    coll = schedules.paper_message_count(p)

    @jax.jit
    def ref_tick(st, x, mags, t):
        key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), t))[1]
        return ref_proto.tick(st, ref_protocols.Obs(
            x=x, update_mag=mags, tick=t, key=key, fp=ref_fp, eps=eps, max_delay=D,
            msg_table=msg_table, coll_cycle_msgs=jnp.int32(coll)))

    d, reply = marker_tables(SEED, TICKS + 1, p, D)
    source = TableSource(d, reply)
    ref_st = ref_proto.init(p, m, ref_cfg)
    st = proto.init(p, m, cfg, 1, "cpu")
    rng = np.random.default_rng(p)
    detected_at = None
    for t in range(1, TICKS + 1):
        noise = rng.standard_normal((p, m)).astype(np.float32) * np.float32(0.6 ** t)
        x = xstar.reshape(p, m) + noise
        mags = np.abs(noise).max(axis=1)
        ref_st, ref_msgs = ref_tick(ref_st, jnp.asarray(x), jnp.asarray(mags), jnp.int32(t))
        tick = torch.tensor([t], dtype=torch.int32)
        st, msgs = proto.tick(st, protocols.Obs(
            x=torch.from_numpy(x)[None], update_mag=torch.from_numpy(mags)[None],
            tick=tick, draw=Draw(source, torch.tensor([SEED]), tick), fp=fp, eps=eps, max_delay=D,
            msg_table=torch.tensor(schedules.stage_message_table(p), dtype=torch.int32),
            coll_cycle_msgs=coll))
        _assert_tree(st, ref_st, f"{name} tick {t}")
        assert msgs.tolist() == [int(ref_msgs)], f"{name} tick {t}"
        if detected_at is None and bool(ref_st["detected"]):
            detected_at = t
    assert detected_at is not None, f"{name} never certified"
    xs = proto.finalize(st, torch.from_numpy(x)[None])
    ref_xs = np.asarray(ref_proto.finalize(ref_st, jnp.asarray(x)))
    np.testing.assert_allclose(xs[0].numpy(), ref_xs, rtol=RTOL, atol=ATOL)


def test_interval_protocol_needs_a_full_quiet_window():
    """interval == inexact hardened: a single small instantaneous update
    cannot certify; the window max must clear eps."""
    p = 4
    proto = protocols.get_protocol("interval")
    cfg = A.AsyncConfig(p=p, max_delay=2, window=0)  # window -> max_delay + 2 = 4
    st = proto.init(p, 16, cfg, 1, "cpu")
    big = torch.full((1, p), 1.0)
    small = torch.full((1, p), 1e-9)

    def obs(t, mags):
        return protocols.Obs(x=None, update_mag=mags, tick=torch.tensor([t], dtype=torch.int32),
                             draw=None, fp=None, eps=1e-6, max_delay=2,
                             msg_table=torch.zeros(1, dtype=torch.int32), coll_cycle_msgs=0)

    t = 1
    for _ in range(6):  # big updates fill the window
        st, _ = proto.tick(st, obs(t, big))
        t += 1
    # one small tick: the window still holds big values -> no certify
    st, _ = proto.tick(st, obs(t, small))
    t += 1
    assert not bool(st["detected"])
    # a full quiet window (+ reduction cycles) -> certify
    for _ in range(16):
        st, _ = proto.tick(st, obs(t, small))
        t += 1
    assert bool(st["detected"])


def test_monitor_has_no_policy_for_engine_only_protocols():
    """``oracle`` and ``sync`` run only in the engine: the training loop's
    monitor refuses them."""
    for mode in ("oracle", "sync"):
        with pytest.raises(ValueError, match="no training-loop policy"):
            A.ConvergenceMonitor(p=3, threshold=1.0, mode=mode).init(device="cpu")
