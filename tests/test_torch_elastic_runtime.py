"""The port's elastic runtime against the reference's, on the CPU: the
policies and the failure detector, the terminations' ``migrate``,
fixed-point serving under chaos, and the serving CLI's elastic flags.

- Policies and detector on scripted inputs: every registered policy's
  decision (action, ids, reason) a step, ``FailureDetector.failed`` and
  ``stragglers`` under scripted heartbeats and step times, the
  ``sla_autoscale`` state machine of ``tests/test_tenants_scale.py``
  (patience, cooldown, min/max extent, counters reset by mixed load,
  ``spawn`` isolation), ``clamp_min_extent``, ``ReplicaSet``'s keep maps
  and the flattened keep maps of a mesh: all equal the reference's.
- Termination ``migrate`` (the reference's ``tests/test_serving_elastic.py``
  cases): a 5 -> 3 shrink and a 3 -> 5 grow in the middle of a window
  under ``residual_interval`` with ``window=0`` (the window's length
  changes with the extent), and random residual traces resized twice
  under both residual protocols: the retire masks and certified values a
  tick, and the migrated monitor rows, equal the reference's; the
  certified latch survives every protocol's migrate.
- A fixed-point chaos run (4 -> 3 -> 5 -> 4) stays certified (true
  residual below eps); its resize events equal the reference's, and its
  admission and retirement ticks too (a tie within an ulp of eps would
  be excused, ROADMAP queue 3); a silent kill is detected at the
  reference's tick; ``apply_due`` fires the events a dispatch jumped over.
- The serving CLI's ``--autoscale --slots-per-replica`` and
  ``--kill/--stall/--join/--unstall`` runs print the reference CLI's
  ``# chaos`` and ``# resize`` lines and serve its tokens at its ticks.

The reference is recorded once for the module.
"""

import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_chaos as tc  # noqa: E402
from repro import runtime as rrt  # noqa: E402
from repro.launch import serve as ref_cli  # noqa: E402
from repro.runtime import elastic as ref_elastic  # noqa: E402
from repro.runtime import policies as ref_policies  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro.serving import TerminationConfig as RefTerminationConfig  # noqa: E402
from repro.serving import get_termination as ref_get_termination  # noqa: E402
from repro.serving import make_workload as ref_make_workload  # noqa: E402
from repro.serving.termination import make_signals as ref_make_signals  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Request,
    ServeConfig,
    ServeEngine,
    TerminationConfig,
    get_termination,
    make_signals,
    make_workload,
)

EPS = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decision(d):
    return (d.action, d.remove, tuple(d.admit), d.reason)


# ---------------------------------------------------------------------------
# Policies, the detector, keep maps
# ---------------------------------------------------------------------------


def test_registries_hold_the_reference_policies():
    assert rt.available() == rrt.available() == sorted(rt.ELASTIC_POLICIES)
    for name in rt.available():
        assert type(rt.get_policy(name)).__name__ == type(rrt.get_policy(name)).__name__
    with pytest.raises(ValueError, match="unknown elastic policy"):
        rt.get_policy("nope")
    pol = rt.SlaAutoscalePolicy()
    assert rt.get_policy(pol) is pol


def _detector_script(seed):
    """A scripted heartbeat history for workers 0-4: per step, which
    workers beat, their step times, the deaths and the joins."""
    rng = np.random.default_rng(seed)
    steps = []
    for t in range(1, 31):
        beats = {w: float(rng.choice([1.0, 1.0, 1.0, 4.0, 12.0])) for w in range(5)
                 if rng.random() > 0.15}
        steps.append({"now": float(t), "beats": beats,
                      "dead": [int(rng.integers(5))] if rng.random() < 0.08 else [],
                      "join": [5 + t] if rng.random() < 0.1 else []})
    return steps


@pytest.mark.parametrize("name", ["static", "shrink_on_failure", "grow_on_join",
                                  "drain_straggler", "sla_autoscale"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policies_and_detector_decide_as_the_reference(name, seed):
    hb = dict(timeout_s=3.0, straggler_factor=2.5, evict_after_straggler_steps=3)
    ours = rt.FailureDetector(list(range(5)), rt.HeartbeatConfig(**hb))
    theirs = rrt.FailureDetector(list(range(5)), rrt.HeartbeatConfig(**hb))
    pol, rpol = rt.get_policy(name).spawn(), rrt.get_policy(name).spawn()
    ids, pending = set(range(5)), []
    rng = np.random.default_rng(seed + 100)
    for st in _detector_script(seed):
        for det in (ours, theirs):
            for w, dt in st["beats"].items():
                if w in ids:
                    det.heartbeat(w, st["now"], step_time=dt)
            for w in st["dead"]:
                det.mark_dead(w)
            for j in st["join"]:
                det.add_worker(j, st["now"])
        pending += st["join"]
        assert ours.failed(st["now"]) == theirs.failed(st["now"])
        load = dict(tick=int(st["now"]) * 3, queue_depth=int(rng.integers(0, 6)),
                    sla_near=int(rng.random() < 0.2), sla_overdue=int(rng.random() < 0.1),
                    free_slots=int(rng.integers(0, 5)), usable_slots=8, dp=len(ids))
        d = pol.decide(ours, st["now"], list(pending), frozenset(ids),
                       load=rt.LoadSnapshot(**load))
        rd = rpol.decide(theirs, st["now"], list(pending), frozenset(ids),
                         load=ref_policies.LoadSnapshot(**load))
        assert _decision(d) == _decision(rd), st["now"]
        assert ours.straggler_strikes == theirs.straggler_strikes
        if d.action == "shrink" and len(ids - d.remove) >= 1:
            for w in d.remove:
                ours.remove_worker(w)
                theirs.remove_worker(w)
            ids -= d.remove
        elif d.action == "grow":
            ids |= set(d.admit)
            pending = [w for w in pending if w not in d.admit]


def _load(mod, tick, *, queue=0, near=0, overdue=0, free=0, usable=8, dp=1):
    return mod.LoadSnapshot(tick=tick, queue_depth=queue, sla_near=near, sla_overdue=overdue,
                            free_slots=free, usable_slots=usable, dp=dp)


# the autoscale state machine's scripted cases (tests/test_tenants_scale.py):
# policy kwargs, live ids, then (now, live ids, load kwargs) a step
AUTOSCALE_CASES = {
    "grows_after_up_patience": (dict(max_extent=4, up_patience=2, cooldown=3), (0, 1), [
        (1.0, (0, 1), dict(tick=1, queue=9)), (2.0, (0, 1), dict(tick=2, queue=9))]),
    "cooldown_suppresses_thrash": (dict(max_extent=4, up_patience=1, cooldown=5), (0,), [
        (1.0, (0,), dict(tick=10, queue=9)), (2.0, (0, 1), dict(tick=12, queue=99)),
        (3.0, (0, 1), dict(tick=15, queue=99))]),
    "shrinks_idle_to_min_extent": (dict(min_extent=2, max_extent=4, down_patience=2, cooldown=0),
                                   (0, 1, 2), [
        (1.0, (0, 1, 2), dict(tick=1, free=8)), (2.0, (0, 1, 2), dict(tick=2, free=8)),
        (3.0, (0, 1), dict(tick=3, free=8)), (4.0, (0, 1), dict(tick=4, free=8)),
        (5.0, (0, 1), dict(tick=5, free=8))]),
    "respects_max_extent": (dict(max_extent=2, up_patience=1, cooldown=0), (0, 1), [
        (float(t), (0, 1), dict(tick=t, queue=50)) for t in range(1, 5)]),
    "mixed_load_resets_counters": (dict(up_patience=2, down_patience=2, cooldown=0), (0, 1), [
        (1.0, (0, 1), dict(tick=1, queue=9)), (2.0, (0, 1), dict(tick=2, queue=0, free=0)),
        (3.0, (0, 1), dict(tick=3, queue=9)), (4.0, (0, 1), dict(tick=4, queue=9))]),
    "sla_pressure_and_slack": (dict(max_extent=6, up_patience=1, cooldown=2,
                                    queue_per_replica=2), (0, 1, 2), [
        (1.0, (0, 1, 2), dict(tick=1, queue=5, free=0, dp=3)),
        (2.0, (0, 1, 2), dict(tick=2, queue=7, free=0, dp=3)),
        (3.0, (0, 1, 2, 3), dict(tick=3, near=1, dp=4)),
        (4.0, (0, 1, 2, 3), dict(tick=5, overdue=2, dp=4))]),
}


@pytest.mark.parametrize("case", sorted(AUTOSCALE_CASES))
def test_autoscale_state_machine_matches_the_reference(case):
    kw, ids0, steps = AUTOSCALE_CASES[case]
    pol, rpol = rt.SlaAutoscalePolicy(**kw), ref_policies.SlaAutoscalePolicy(**kw)
    det = rt.FailureDetector(list(ids0), rt.HeartbeatConfig())
    rdet = rrt.FailureDetector(list(ids0), rrt.HeartbeatConfig())
    actions = []
    for now, ids, load in steps:
        d = pol.decide(det, now, [], frozenset(ids), load=_load(rt, **load))
        rd = rpol.decide(rdet, now, [], frozenset(ids), load=_load(ref_policies, **load))
        assert _decision(d) == _decision(rd), (case, now)
        assert (pol._up, pol._down, pol._cool_until) == (rpol._up, rpol._down, rpol._cool_until)
        actions.append(d.action)
    assert actions != ["none"] * len(steps) or case == "respects_max_extent"


def test_autoscale_spawn_isolates_state_and_validates_extents():
    reg = rt.get_policy("sla_autoscale")
    a, b = reg.spawn(), reg.spawn()
    assert a is not reg and a is not b
    a._up = 99
    assert b._up == 0
    static = rt.get_policy("static")
    assert static.spawn() is static
    det = rt.FailureDetector([0], rt.HeartbeatConfig())
    assert a.decide(det, 1.0, [], frozenset({0})).action == "none"  # no load: the parent
    for bad in (dict(min_extent=0), dict(min_extent=4, max_extent=2)):
        with pytest.raises(ValueError):
            rt.SlaAutoscalePolicy(**bad)
        with pytest.raises(ValueError):
            ref_policies.SlaAutoscalePolicy(**bad)


@pytest.mark.parametrize("remove,live,min_extent", [
    ({0, 1, 2}, [0, 1, 2, 3], 1), ({0, 1, 2}, [0, 1, 2], 3), ({0, 1, 2}, [0, 1, 2, 3], 3),
    ({3}, [1, 3], 2), ({5, 7}, [5, 6, 7], 2)])
def test_clamp_min_extent_matches_the_reference(remove, live, min_extent):
    d = rt.ResizeDecision("shrink", remove=frozenset(remove), reason="hb")
    rd = ref_policies.ResizeDecision("shrink", remove=frozenset(remove), reason="hb")
    out = rt.clamp_min_extent(d, live, min_extent)
    assert _decision(out) == _decision(ref_policies.clamp_min_extent(rd, live, min_extent))
    assert (out is d) == (len([w for w in live if w not in remove]) >= min_extent)
    g = rt.ResizeDecision("grow", admit=(7,))
    assert rt.clamp_min_extent(g, [0], 1) is g


def test_replica_set_and_flat_keep_maps_match_the_reference():
    ours, theirs = rt.ReplicaSet([0, 1, 2, 3]), rrt.ReplicaSet([0, 1, 2, 3])
    for op, arg in (("remove", {2}), ("add", [4, 5]), ("add", [4]), ("remove", {0, 5}),
                    ("add", [9])):
        assert getattr(ours, op)(arg) == getattr(theirs, op)(arg)
        assert ours.dp == theirs.dp
    with pytest.raises(RuntimeError, match="no live replicas"):
        ours.remove(set(ours.ids))
    with pytest.raises(ValueError, match="duplicate"):
        rt.ReplicaSet([1, 1])

    class Mesh:  # the reference reads ``mesh.shape[axis]``
        shape = {"pod": 2, "data": 3, "model": 2}

    axes = ("pod", "data")
    for kept in ((0, 2), (1,), (0, 1, 2)):
        assert (rt.flat_keep_for_shrink(Mesh.shape, axes, "data", kept)
                == ref_elastic.flat_keep_for_shrink(Mesh, axes, "data", kept))
    for n_new in (1, 2):
        for axis in axes:
            assert (rt.flat_keep_for_grow(Mesh.shape, axes, axis, n_new)
                    == ref_elastic.flat_keep_for_grow(Mesh, axes, axis, n_new))


def test_step_clock_and_resize_event():
    c = rt.StepClock(dt=0.5, t0=1.0)
    assert (c.now(), c.advance(), c.advance(), c.now()) == (1.0, 1.5, 2.0, 2.0)
    fields = [f.name for f in dataclasses.fields(rt.ResizeEvent)]
    assert fields == [f.name for f in dataclasses.fields(ref_elastic.ResizeEvent)]
    assert rt.ElasticConfig().policy == ref_elastic.ElasticConfig().policy


# ---------------------------------------------------------------------------
# Termination migrate against the reference's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_tick(name):
    return jax.jit(ref_get_termination(name).tick, static_argnums=(2,))


class _Pair:
    """One termination in both packages, fed the same signals (the
    reference's tick jitted, as its engine runs it)."""

    def __init__(self, name, dp, slots, window=0, eps=1e-3):
        self.term, self.ref = get_termination(name), ref_get_termination(name)
        self.slots, self.eps, self.window = slots, eps, window
        self._cfg(dp)
        self.st = self.term.init(self.cfg, slots, device="cpu")
        self.rst = self.ref.init(self.rcfg, slots)

    def _cfg(self, dp):
        self.dp = dp
        self.cfg = TerminationConfig(dp=dp, eps=self.eps, window=self.window)
        self.rcfg = RefTerminationConfig(dp=dp, eps=self.eps, window=self.window)

    def tick(self, tick, active, admit, residual):
        S = self.slots
        new_tokens = np.full(S, 5)
        kw = dict(tokens=np.zeros(S), new_tokens=new_tokens, eos=np.full(S, -1),
                  max_new=np.full(S, 1000), admit_tick=admit)
        sig = make_signals(**{k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in kw.items()},
                           eps=torch.full((S,), self.eps), active=torch.from_numpy(active.copy()),
                           tick=tick, residual=torch.from_numpy(residual.astype(np.float32)))
        rsig = ref_make_signals(**{k: jnp.asarray(v, jnp.int32) for k, v in kw.items()},
                                eps=jnp.full((S,), self.eps, jnp.float32),
                                active=jnp.asarray(active), tick=jnp.int32(tick),
                                residual=jnp.asarray(residual, jnp.float32))
        self.st, retire = self.term.tick(self.st, sig, self.cfg)
        self.rst, rretire = _ref_tick(self.term.name)(self.rst, rsig, self.rcfg)
        retire = retire.numpy()
        np.testing.assert_array_equal(retire, np.asarray(rretire), err_msg=f"tick {tick}")
        np.testing.assert_array_equal(self.st["certified"].numpy(),
                                      np.asarray(self.rst["certified"]))
        return retire

    def migrate(self, keep):
        self._cfg(len(keep))
        self.st = self.term.migrate(self.st, keep, self.cfg, self.slots)
        self.rst = self.ref.migrate(self.rst, keep, self.rcfg, self.slots)
        assert self.st["nb"]["stage"] == int(self.rst["nb"]["stage"]) == 0
        np.testing.assert_array_equal(self.st["certified"].numpy(),
                                      np.asarray(self.rst["certified"]))
        for k, v in self.st.get("m", {}).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(self.rst["m"][k]), err_msg=k)


def _mid_window(pair, before, high_rank, keep, after_high, n_after):
    """``before`` ticks with ``high_rank`` far from converged (and the
    rest low), a migrate along ``keep`` in the middle of the cycle, then
    ``n_after`` ticks with ``after_high`` high, then everyone low until
    both packages retire every slot."""
    S = pair.slots
    active, admit = np.ones(S, bool), np.zeros(S, np.int64)
    tick = 0
    for _ in range(before):
        res = np.full((pair.dp, S), 1e-6)
        res[high_rank] = 1.0
        assert not pair.tick(tick, active, admit, res).any()
        tick += 1
    pair.migrate(keep)
    for _ in range(n_after):
        res = np.full((pair.dp, S), 1e-6)
        res[after_high] = 1.0
        assert not pair.tick(tick, active, admit, res).any(), "retired while a replica is high"
        tick += 1
    retired = np.zeros(S, bool)
    for _ in range(8 * pair.term.cycle_length(pair.cfg) + 8):
        retired |= pair.tick(tick, active, admit, np.full((pair.dp, S), 1e-6))
        active = active & ~retired
        tick += 1
        if retired.all():
            break
    assert retired.all()
    assert (pair.st["certified"].numpy() < pair.eps).all()


def test_interval_migrate_shrinks_in_the_middle_of_a_window():
    pair = _Pair("residual_interval", 5, 2)
    before = pair.term.cycle_length(pair.cfg) // 2 + 1
    # survivors 0, 1, 2: the derived window's length differs at 3
    _mid_window(pair, before, 1, (0, 1, 2), 1,
                3 * get_termination("residual_interval").cycle_length(
                    TerminationConfig(dp=3)) + 3)


def test_interval_migrate_grows_in_the_middle_of_a_window():
    pair = _Pair("residual_interval", 3, 2)
    before = pair.term.cycle_length(pair.cfg) // 2 + 1
    # a joiner (rank 4) reports high after the grow: nothing may retire
    _mid_window(pair, before, 2, (0, 1, 2, None, None), 4,
                3 * get_termination("residual_interval").cycle_length(
                    TerminationConfig(dp=5)) + 3)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("name", ["residual_inexact", "residual_interval"])
def test_migrate_on_random_traces_with_recycled_slots(name, window):
    """Random residuals around eps over 4 slots recycled at random ticks,
    resized 4 -> 3 (keep 0, 1, 3) and 3 -> 5 (two joiners) mid-cycle."""
    rng = np.random.default_rng(3 + window)
    pair = _Pair(name, 4, 4, window=window, eps=1e-3)
    active, admit = np.ones(4, bool), np.zeros(4, np.int64)
    plan = {5: (0, 1, 3), 12: (0, 1, 2, None, None)}
    retired = 0
    for tick in range(30):
        if tick in plan:
            pair.migrate(plan[tick])
        for s in np.nonzero(~active | (rng.random(4) < 0.05))[0]:
            active[s], admit[s] = True, tick  # a new request in a recycled slot
        res = 10.0 ** rng.uniform(-5.5, -2.8, size=(pair.dp, 4))
        done = pair.tick(tick, active, admit, res)
        retired += int(done.sum())
        active &= ~done
    assert retired >= 3


@pytest.mark.parametrize("name", ["eos_maxlen", "residual_inexact", "residual_interval"])
@pytest.mark.parametrize("keep", [(0, 1, 3), (0, 1, 2, 3, None)])
def test_migrate_keeps_the_certified_latch(name, keep):
    pair = _Pair(name, 4, 3)
    pair.st["certified"] = torch.tensor([0.5, 1e-9, 0.5])
    pair.rst["certified"] = jnp.asarray([0.5, 1e-9, 0.5], jnp.float32)
    pair.migrate(keep)
    np.testing.assert_array_equal(pair.st["certified"].numpy(), np.float32([0.5, 1e-9, 0.5]))


# ---------------------------------------------------------------------------
# Fixed-point serving under chaos, silent kills, apply_due
# ---------------------------------------------------------------------------


def _fp_requests(cls):
    """The reference chaos suite's fixed-point traffic."""
    rng = np.random.default_rng(7)
    arrivals = tc.poisson_arrivals(rng, 8, mean_gap=4.0)
    out = []
    for i in range(8):
        v = rng.random(60).astype(np.float32)
        out.append(cls(id=i, arrival=int(arrivals[i]), payload=v / v.sum(), max_new=800))
    return out


def _events(resizes):
    return [(e.kind, e.step, e.old_dp, e.new_dp, e.keep, e.reason) for e in resizes]


@functools.lru_cache(maxsize=None)
def _ref_fixedpoint_chaos():
    wl = ref_make_workload("fixedpoint_solve", solver="d_iteration", n=60, dp=4, slots=3,
                           damping=0.7, seed=1)
    eng = RefServeEngine(wl, RefServeConfig(termination="residual_interval", dp=4, eps=EPS,
                                            steps_per_dispatch=3))
    ctl = rrt.ElasticServeController(eng, policy="grow_on_join")
    res = ctl.run(_fp_requests(RefRequest), events=tc.script())
    return _events(ctl.resizes), {i: (r.admit_tick, r.retire_tick, r.certified)
                                  for i, r in res.items()}


def test_fixedpoint_chaos_stays_certified_and_matches_the_reference():
    ref_events, ref_res = _ref_fixedpoint_chaos()
    wl = make_workload("fixedpoint_solve", solver="d_iteration", n=60, dp=4, slots=3,
                       damping=0.7, seed=1, device="cpu")
    eng = ServeEngine(wl, ServeConfig(termination="residual_interval", dp=4, eps=EPS,
                                      steps_per_dispatch=3))
    ctl = rt.ElasticServeController(eng, policy="grow_on_join")
    reqs = _fp_requests(Request)
    script = tc.script()
    res = ctl.run(reqs, events=script)
    assert len(script.fired) == 5
    assert _events(ctl.resizes) == ref_events
    assert tc.trajectory(ctl.resizes) == tc.TRAJECTORY and wl.dp == wl.pool.dp == 4
    assert sorted(res) == sorted(ref_res) == list(range(8))
    ulp = float(np.spacing(np.float32(EPS)))
    for i, r in res.items():
        assert r.converged and r.certified < EPS, i
        x, v = torch.from_numpy(r.output), torch.from_numpy(reqs[i].payload)
        assert float((wl.pool.param_map(x, v) - x).abs().amax()) < EPS, i
        admit, retire, cert = ref_res[i]
        if (r.admit_tick, r.retire_tick) != (admit, retire):
            # only a threshold tie may move a tick (ROADMAP queue 3)
            assert min(abs(cert - EPS), abs(r.certified - EPS)) <= ulp, (i, cert, r.certified)
        assert abs(r.certified - cert) <= 1e-2 * EPS, (i, cert, r.certified)


def _silent_kill(make, Engine, Config, R, mod, **kw):
    wl = make("fixedpoint_solve", solver="d_iteration", n=60, dp=3, slots=2, damping=0.7,
              seed=1, **kw)
    eng = Engine(wl, Config(termination="residual_inexact", dp=3, eps=1e-5,
                            steps_per_dispatch=2))
    ctl = mod.ElasticServeController(eng, policy="shrink_on_failure",
                                     heartbeat=mod.HeartbeatConfig(timeout_s=5.0),
                                     clock=mod.StepClock(dt=1.0))
    ctl.kill(1, silent=True)  # a partition: no crash report
    res = ctl.run([R(id=i, arrival=3 * i, max_new=500) for i in range(4)])
    assert len(res) == 4 and all(r.converged for r in res.values())
    return _events(ctl.resizes), {i: (r.admit_tick, r.retire_tick) for i, r in res.items()}


def test_silent_kill_is_detected_at_the_references_tick():
    ours = _silent_kill(make_workload, ServeEngine, ServeConfig, Request, rt, device="cpu")
    theirs = _silent_kill(ref_make_workload, RefServeEngine, RefServeConfig, RefRequest, rrt)
    assert ours == theirs
    (kind, step, old, new, keep, _), = ours[0]
    assert (kind, old, new, keep) == ("shrink", 3, 2, (0, 2)) and step > 0


def test_apply_due_fires_the_events_a_dispatch_jumped_over():
    fired = []

    class Target:
        def kill(self, d, silent=False):
            fired.append(("kill", d))

        def join(self, ds):
            fired.append(("join", ds))

    s = tc.ChaosScript([tc.Kill(step=3, device=0), tc.Join(step=7, devices=(9,))])
    s.apply_due(Target(), 2)
    assert fired == []
    s.apply_due(Target(), 5)
    assert fired == [("kill", 0)]
    s.apply_due(Target(), 50)
    assert fired == [("kill", 0), ("join", (9,))]
    s.apply_due(Target(), 51)
    assert len(s.fired) == 2
    script = tc.ChaosScript.random(3, 40, [0, 1, 2, 3], [4, 5], min_extent=2)
    assert 0 < len(script.events) <= 4


def test_controller_spares_the_last_replica_and_serves_on():
    wl = make_workload("fixedpoint_solve", solver="d_iteration", n=60, dp=2, slots=2,
                       damping=0.7, seed=1, device="cpu")
    eng = ServeEngine(wl, ServeConfig(termination="residual_inexact", dp=2, eps=1e-5,
                                      steps_per_dispatch=4))
    ctl = rt.ElasticServeController(eng, policy="shrink_on_failure", min_extent=1)
    ctl.kill(0)
    ctl.kill(1)
    res = ctl.run([Request(id=0, max_new=500), Request(id=1, arrival=2, max_new=500)])
    assert len(res) == 2 and all(r.converged for r in res.values())
    assert eng.dp == 1 and [(e.old_dp, e.new_dp) for e in ctl.resizes] == [(2, 1)]
    assert ctl.health[0] == "ok"  # pressed back into service, not left flapping
    with pytest.raises(ValueError, match="replica ids"):
        rt.ElasticServeController(eng, replica_ids=[0, 1, 2])


def test_slots_per_replica_bounds_admission_and_the_load_snapshot():
    wl = make_workload("fixedpoint_solve", solver="d_iteration", n=12, dp=1, slots=4,
                       damping=0.5, device="cpu")
    eng = ServeEngine(wl, ServeConfig(termination="residual_interval", eps=1e-2, dp=1,
                                      slots_per_replica=2))
    assert eng.usable_slots == 2
    for i in range(4):
        eng.submit(Request(id=i, max_new=500, sla=4 if i % 2 else None))
    snap = eng.load_snapshot()
    assert (snap.queue_depth, snap.free_slots, snap.usable_slots, snap.dp) == (4, 2, 2, 1)
    eng.run([])
    assert sum(1 for r in eng.results.values() if r.admit_tick == 0) == 2
    eng.resize(2, (0, None))
    assert eng.usable_slots == 4 and eng.load_snapshot().free_slots == 4


# ---------------------------------------------------------------------------
# The serving CLI's elastic flags against the reference CLI
# ---------------------------------------------------------------------------

AUTOSCALE_ARGV = ["--arch", "llama3.2-1b", "--smoke", "--continuous", "--workload", "llm_decode",
                  "--slots", "8", "--requests", "16", "--scheduler", "sla_edf",
                  "--tenants", "chat:3:sla=8:prio=2,batch:1:quota=4:gen=24",
                  "--arrival", "bursty:0.2,2.0", "--dp", "2", "--slots-per-replica", "4",
                  "--autoscale", "--max-extent", "4", "--steps-per-dispatch", "4"]
KILLJOIN_ARGV = ["--arch", "llama3.2-1b", "--smoke", "--continuous", "--workload",
                 "llm_decode_paged", "--slots", "4", "--requests", "12", "--arrival",
                 "poisson:0.5", "--dp", "4", "--elastic-policy", "grow_on_join",
                 "--steps-per-dispatch", "4", "--kill", "6:2", "--stall", "10:1",
                 "--join", "16:4,5", "--unstall", "22:1", "--kill", "26:0"]


def _elastic_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(("# chaos", "# resize"))]


@pytest.mark.parametrize("argv", [AUTOSCALE_ARGV, KILLJOIN_ARGV], ids=["autoscale", "killjoin"])
def test_cli_elastic_stream_equals_the_reference_clis(monkeypatch, argv):
    engines = []

    class Recorded(RefServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(ref_cli, "ServeEngine", Recorded)
    with contextlib.redirect_stdout(io.StringIO()) as ref_out:
        ref_cli.main(argv)
    ref_eng = engines[0]
    cfg = registry.get_smoke_config("llama3.2-1b")
    params = params_from_reference(jax.tree.map(np.asarray, ref_eng.workload.params), cfg,
                                   device="cpu")
    monkeypatch.setattr(cli, "make_workload", functools.partial(make_workload, params=params))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        eng = cli.main(argv + ["--device", "cpu"])
    lines = _elastic_lines(out.getvalue())
    assert lines == _elastic_lines(ref_out.getvalue())
    assert any(ln.startswith("# resize") for ln in lines)
    assert _events(eng.resizes) == _events(ref_eng.resizes)
    assert eng.dp == ref_eng.dp and eng.summary()["resizes"] == len(ref_eng.resizes)
    assert sorted(eng.results) == sorted(ref_eng.results)
    for i, r in ref_eng.results.items():
        np.testing.assert_array_equal(eng.results[i].output, r.output, err_msg=f"request {i}")
        assert (eng.results[i].admit_tick, eng.results[i].retire_tick) == (
            r.admit_tick, r.retire_tick), i
    assert f"final dp {eng.dp}" in out.getvalue()
