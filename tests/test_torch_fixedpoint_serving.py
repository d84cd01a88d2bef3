"""The port's fixed-point serving against the reference's.

- The residual terminations (``residual_inexact``, ``residual_interval``)
  fed the same random fp32 residual traces as the reference's, with slots
  recycled mid-run: retire masks and certified values equal exactly (the
  agreement is a max, the comparison against eps the same fp32 test).
- The engine on ``fixedpoint_solve`` against the reference engine on the
  same requests (``d_iteration``, ``poisson1d`` with the reference's rhs
  passed in, ``jacobi_dense``): admission and retirement ticks, iterations
  and ``converged`` equal; solutions within 1e-6 of the reference
  solution's largest magnitude (fp32 rounding of the maps: ``x @ P^T``
  sums in another order than the reference's XLA dot); certified values
  within 1e-2 eps (they are differences of iterates, carrying that
  rounding).
- The engine's mechanics (budget-forced retirement, no inherited
  certification, residual termination refused for LLM decode), the
  ``priority`` and ``sla_edf`` schedulers' ``select`` against the
  reference's, and the CLI's fixed-point request stream.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro.serving import TerminationConfig as RefTerminationConfig  # noqa: E402
from repro.serving import get_scheduler as ref_get_scheduler  # noqa: E402
from repro.serving import get_termination as ref_get_termination  # noqa: E402
from repro.serving import make_workload as ref_make_workload  # noqa: E402
from repro.serving.termination import make_signals as ref_make_signals  # noqa: E402
from repro_torch.asynchrony.protocols import RES_INIT, get_protocol  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    SCHEDULERS,
    TERMINATION,
    WORKLOADS,
    Request,
    ServeConfig,
    ServeEngine,
    TerminationConfig,
    get_scheduler,
    get_termination,
    make_signals,
    make_workload,
)


def test_registries_hold_the_fixedpoint_entries():
    assert {"eos_maxlen", "residual_inexact", "residual_interval"} <= set(TERMINATION)
    assert {"fcfs", "priority", "sla_edf"} <= set(SCHEDULERS)
    assert {"llm_decode", "llm_decode_paged", "fixedpoint_solve"} <= set(WORKLOADS)


def test_only_the_ported_schedule_is_accepted():
    """Every registered schedule is ported, so the config takes each name,
    as the reference's does; one that cannot step a stage at a time raises
    the reference's error where the plan is first measured."""
    from repro.collectives.schedules import SCHEDULES as REF_SCHEDULES
    from repro.serving import termination as ref_term
    from repro_torch.collectives.schedules import SCHEDULES

    assert TerminationConfig(dp=3).schedule == "mrd"
    assert set(SCHEDULES) == set(REF_SCHEDULES) == {"mrd", "rabenseifner", "hierarchical"}
    term, ref = get_termination("residual_interval"), ref_term.get_termination("residual_interval")
    for name in sorted(SCHEDULES):
        cfg = TerminationConfig(dp=3, schedule=name, window=2)
        rcfg = ref_term.TerminationConfig(dp=3, schedule=name, window=2)
        assert cfg.schedule == rcfg.schedule == name
        if name == "mrd":
            assert term.cycle_length(cfg) == ref.cycle_length(rcfg) == 3
            continue
        with pytest.raises(ValueError) as ours:
            term.cycle_length(cfg)
        with pytest.raises(ValueError) as theirs:
            ref.cycle_length(rcfg)
        assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Termination: the same residual traces through both packages' tick
# ---------------------------------------------------------------------------

SLOTS, T = 4, 48


def _port_sig(t, active, admit, residual, eps):
    S = active.shape[0]
    return make_signals(
        tokens=torch.zeros(S, dtype=torch.long), new_tokens=torch.zeros(S, dtype=torch.long),
        eos=torch.full((S,), -1, dtype=torch.long), max_new=torch.full((S,), 10**6),
        eps=torch.from_numpy(eps), active=torch.from_numpy(active),
        admit_tick=torch.from_numpy(admit.astype(np.int64)), tick=t,
        residual=torch.from_numpy(residual))


def _ref_sig(t, active, admit, residual, eps):
    S = active.shape[0]
    return ref_make_signals(
        tokens=jnp.zeros(S, jnp.int32), new_tokens=jnp.zeros(S, jnp.int32),
        eos=jnp.full((S,), -1, jnp.int32), max_new=jnp.full((S,), 10**6, jnp.int32),
        eps=jnp.asarray(eps), active=jnp.asarray(active),
        admit_tick=jnp.asarray(admit, jnp.int32), tick=jnp.int32(t),
        residual=jnp.asarray(residual))


@pytest.mark.parametrize("window", [0, 1])
@pytest.mark.parametrize("dp", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("name", ["residual_inexact", "residual_interval"])
def test_termination_matches_reference_on_random_traces(name, dp, window):
    """Random fp32 update magnitudes that fall through each slot's eps as
    the request ages (from 0.1-20x eps at admission, /2 a tick, times a
    random factor in [1/4, 4] per replica and tick; a slot's magnitude on
    one replica exactly eps one tick in 16), RES_INIT for an empty slot; a
    retired slot, or one forced out (one in 20 a tick, as by its budget),
    stays empty 0-2 ticks and is re-admitted mid-cycle.  Equal retire
    masks and certified values at every tick."""
    rng = np.random.default_rng(1000 * dp + 10 * window + len(name))
    ref, ours = ref_get_termination(name), get_termination(name)
    rcfg = RefTerminationConfig(dp=dp, eps=1e-3, window=window)
    cfg = TerminationConfig(dp=dp, eps=1e-3, window=window)
    rst, st = ref.init(rcfg, SLOTS), ours.init(cfg, SLOTS, device="cpu")
    rtick = jax.jit(ref.tick, static_argnums=2)
    eps = rng.choice([1e-3, 3e-4], size=SLOTS).astype(np.float32)
    active = np.ones(SLOTS, bool)
    admit = np.zeros(SLOTS, np.int32)
    readmit = np.full(SLOTS, -1)
    level = eps * 10.0 ** rng.uniform(-1.0, 1.3, size=SLOTS)
    retired = 0
    for t in range(T):
        for s in np.nonzero(readmit == t)[0]:
            active[s], admit[s] = True, t
            level[s] = eps[s] * 10.0 ** rng.uniform(-1.0, 1.3)
        mag = level * 0.5 ** (t - admit) * 4.0 ** rng.uniform(-1.0, 1.0, size=(dp, SLOTS))
        hit = rng.random(SLOTS) < 1 / 16
        mag[rng.integers(0, dp), hit] = eps[hit]
        residual = np.where(active, mag, RES_INIT).astype(np.float32)
        rst, rretire = rtick(rst, _ref_sig(t, active, admit, residual, eps), rcfg)
        st, retire = ours.tick(st, _port_sig(t, active, admit, residual, eps), cfg)
        np.testing.assert_array_equal(retire.numpy(), np.asarray(rretire), err_msg=f"tick {t}")
        np.testing.assert_array_equal(st["certified"].numpy(), np.asarray(rst["certified"]))
        # a retired slot, or one whose budget ran out (one in 20 a tick),
        # is empty until its re-admission
        out = retire.numpy() | (active & (rng.random(SLOTS) < 1 / 20))
        for s in np.nonzero(out)[0]:
            active[s] = False
            readmit[s] = t + 1 + rng.integers(0, 3)
        retired += int(retire.sum())
    assert retired >= 2 * SLOTS  # the traces exercise retirement and recycling


def _sig_const(dp, tick, residual, eps=1e-3):
    return make_signals(
        tokens=torch.zeros(2, dtype=torch.long), new_tokens=torch.full((2,), 5),
        eos=torch.full((2,), -1), max_new=torch.full((2,), 1000),
        eps=torch.full((2,), eps), active=torch.ones(2, dtype=torch.bool),
        admit_tick=torch.zeros(2, dtype=torch.long), tick=tick,
        residual=torch.from_numpy(residual))


@pytest.mark.parametrize("dp", [3, 5, 6])
def test_residual_interval_waits_for_agreed_max(dp):
    """One replica's converged local view never retires a slot: the agreed
    value is the max over replicas, reduced by a full MRD cycle (the
    reference's test of the same name)."""
    from repro_torch.collectives import schedules

    term = get_termination("residual_interval")
    tcfg = TerminationConfig(dp=dp, eps=1e-3, window=1)
    st = term.init(tcfg, 2, device="cpu")
    cyc = term.cycle_length(tcfg)
    assert cyc == len(schedules.allreduce_schedule(dp))
    mixed = np.full((dp, 2), 1e-6, np.float32)
    mixed[-1, :] = 1.0
    tick = 0
    for _ in range(3 * cyc):
        st, retire = term.tick(st, _sig_const(dp, tick, mixed), tcfg)
        assert not retire.any(), "retired on a local view"
        tick += 1
    low = np.full((dp, 2), 1e-6, np.float32)
    seen = []
    for _ in range(2 * cyc + 1):
        st, retire = term.tick(st, _sig_const(dp, tick, low), tcfg)
        assert retire.all() or not retire.any(), "slots must retire together here"
        if retire.any():
            seen.append(tick)
            break
        tick += 1
    assert seen, f"no certification within two cycles at dp={dp}"
    assert (st["certified"] < tcfg.eps).all()


def test_interval_policy_over_replicas_and_slots_equals_per_slot_vectors():
    """The interval policy generalised to [dp, S] equals running it on each
    slot's [dp] vector, as the ConvergenceMonitor does."""
    proto = get_protocol("interval")
    rng = np.random.default_rng(5)
    m = proto.monitor_init(torch.full((3, 4), RES_INIT), window=3)
    cols = [proto.monitor_init(torch.full((3,), RES_INIT), window=3) for _ in range(4)]
    for step in range(7):
        metric = torch.from_numpy(rng.random((3, 4)).astype(np.float32))
        m, out = proto.monitor_contribution(m, metric, step, 2)
        for s in range(4):
            cols[s], col = proto.monitor_contribution(cols[s], metric[:, s], step, 2)
            torch.testing.assert_close(out[:, s], col, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The engine against the reference engine
# ---------------------------------------------------------------------------


def _diter_requests(R, n=60):
    """The traffic of the reference's certification-soundness test."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(5):
        v = rng.random(n).astype(np.float32)
        out.append(R(id=i, arrival=2 * i, payload=v / v.sum(), max_new=800))
    return out


def _run_both(solver, n, dp, termination, eps, slots, requests, **kw):
    rwl = ref_make_workload("fixedpoint_solve", solver=solver, n=n, dp=dp, slots=slots, **kw)
    ref = RefServeEngine(rwl, RefServeConfig(termination=termination, dp=dp, eps=eps)).run(
        requests(RefRequest))
    wl = make_workload("fixedpoint_solve", solver=solver, n=n, dp=dp, slots=slots,
                       device="cpu", **kw)
    reqs = requests(Request)
    ours = ServeEngine(wl, ServeConfig(termination=termination, dp=dp, eps=eps)).run(reqs)
    assert sorted(ours) == sorted(ref) == [r.id for r in reqs]
    for i in ref:
        a, b = ref[i], ours[i]
        assert (b.admit_tick, b.retire_tick, b.n_tokens, b.converged) == (
            a.admit_tick, a.retire_tick, a.n_tokens, a.converged), i
        assert b.converged and b.certified < eps
        scale = float(np.abs(a.output).max())
        np.testing.assert_allclose(b.output, a.output, rtol=0, atol=1e-6 * scale)
        assert abs(b.certified - a.certified) <= 1e-2 * eps, (i, a.certified, b.certified)
        # soundness: the true residual under the request's own payload
        assert _true_residual(wl, b.output, reqs[i].payload) < eps
    return ours


def _true_residual(wl, x, payload):
    x = torch.from_numpy(x)
    v = torch.from_numpy(np.asarray(payload, np.float32))
    return float((wl.pool.param_map(x, v) - x).abs().amax())


@pytest.mark.parametrize("dp", [1, 3, 5])
@pytest.mark.parametrize("termination", ["residual_interval", "residual_inexact"])
def test_engine_matches_reference_on_d_iteration(termination, dp):
    _run_both("d_iteration", 60, dp, termination, 1e-6, 3, _diter_requests,
              damping=0.7, seed=1)


def test_engine_matches_reference_on_poisson1d():
    """n 32, shift 2.0, dp 2; the base rhs is passed in, as the reference
    draws its own with jax.random; three payloads, two slots."""
    rng = np.random.default_rng(11)
    rhs0 = rng.uniform(-10, 10, size=32).astype(np.float32)
    payloads = [rng.uniform(-5, 5, size=32).astype(np.float32) for _ in range(3)]
    ours = _run_both("poisson1d", 32, 2, "residual_interval", 1e-5, 2,
                     lambda R: [R(id=i, arrival=i, payload=p, max_new=3000)
                                for i, p in enumerate(payloads)],
                     shift=2.0, rhs=rhs0)
    assert not np.allclose(ours[0].output, ours[1].output)  # different systems


def test_engine_matches_reference_on_jacobi_dense():
    """n 42 (a multiple of dp 3), the default random diagonally dominant
    system, four right-hand sides."""
    rng = np.random.default_rng(3)
    payloads = [rng.uniform(-10, 10, size=42).astype(np.float32) for _ in range(4)]
    _run_both("jacobi_dense", 42, 3, "residual_interval", 1e-5, 3,
              lambda R: [R(id=i, arrival=i, payload=p, max_new=500)
                         for i, p in enumerate(payloads)])


# ---------------------------------------------------------------------------
# Engine mechanics (the reference's tests of the same behaviour)
# ---------------------------------------------------------------------------


def _diter(n, dp, slots, damping=0.85):
    return make_workload("fixedpoint_solve", solver="d_iteration", n=n, dp=dp, slots=slots,
                         damping=damping, device="cpu")


def test_true_residual_reads_the_slot_under_a_payload():
    """``true_residual(slot, payload)`` is the certified bound's ground
    truth for the slot's last occupant (``None``: the default payload)."""
    wl = _diter(30, 1, 1, 0.5)
    eng = ServeEngine(wl, ServeConfig(termination="residual_inexact", eps=1e-6))
    v = np.random.default_rng(2).random(30).astype(np.float32)
    res = eng.run([Request(id=0, payload=v / v.sum(), max_new=500)])
    assert res[0].converged
    assert wl.true_residual(0, v / v.sum()) == _true_residual(wl, res[0].output, v / v.sum())
    assert wl.true_residual(0, v / v.sum()) < 1e-6 < wl.true_residual(0, None)


def test_budget_forces_unconverged_retirement():
    eng = ServeEngine(_diter(30, 2, 2, 0.9),
                      ServeConfig(termination="residual_interval", dp=2, eps=1e-12))
    res = eng.run([Request(id=0, max_new=20)])
    assert not res[0].converged and res[0].certified == RES_INIT
    # admission performs no iteration: exactly max_new pool iterations
    assert res[0].n_tokens == 20
    assert res[0].retire_tick - res[0].admit_tick == 19
    assert eng.summary()["forced_at_capacity"] == 0


def test_forced_retirement_does_not_inherit_recycled_certification():
    eng = ServeEngine(_diter(30, 1, 1, 0.5),
                      ServeConfig(termination="residual_inexact", dp=1, eps=1e-4))
    res = eng.run([Request(id=0, max_new=500), Request(id=1, max_new=5, eps=1e-12)])
    assert res[0].converged and res[0].certified < 1e-4
    assert not res[1].converged
    assert res[1].certified == RES_INIT, "inherited the predecessor's residual"


def test_engine_rejects_residual_termination_for_llm():
    from repro_torch.configs import registry

    wl = make_workload("llm_decode", cfg=registry.get_smoke_config("llama3.2-1b"), slots=2,
                       max_len=16, max_prompt_len=4, device="cpu")
    with pytest.raises(ValueError, match="residual"):
        ServeEngine(wl, ServeConfig(termination="residual_interval"))


def test_engine_and_workload_must_agree_on_dp():
    """The engine aligns a workload built at another extent, as a resize
    does (the reference's rule); an extent the problem does not divide
    into is refused."""
    wl = _diter(30, 3, 2)
    eng = ServeEngine(wl, ServeConfig(termination="residual_interval", dp=2))
    assert eng.dp == wl.dp == wl.pool.dp == 2
    with pytest.raises(ValueError, match="dp"):
        ServeEngine(_diter(30, 3, 2), ServeConfig(termination="residual_interval", dp=4))


def test_summary_metrics_present():
    eng = ServeEngine(_diter(20, 1, 2, 0.5), ServeConfig(termination="residual_inexact", eps=1e-5))
    res = eng.run([Request(id=0, max_new=200, sla=3),
                   Request(id=1, arrival=3, max_new=200)])
    s = eng.summary()
    assert s["completed"] == 2 and s["converged"] == 2
    for k in ("throughput_tok_s", "ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms", "tpot_p95_ms",
              "occupancy", "wall_s"):
        assert np.isfinite(s[k]), k
    assert 0 < s["occupancy"] <= 1
    assert res[0].sla == 3 and res[0].sla_met is True and res[1].sla_met is None
    assert res[0].output.shape == (20,) and res[0].output.dtype == np.float32


def test_pool_checks_its_shapes_and_solvers():
    with pytest.raises(ValueError, match="divide"):
        _diter(30, 4, 2)
    wl = _diter(30, 3, 2)
    with pytest.raises(ValueError, match="payload shape"):
        wl.pool.admit(np.zeros(29, np.float32), 0)
    with pytest.raises(ValueError, match="affine-payload"):
        make_workload("fixedpoint_solve", solver="poisson2d", n=16, device="cpu")


def test_inactive_slots_report_res_init_and_keep_their_iterate():
    wl = _diter(30, 3, 2)
    wl.admit(Request(id=0, payload=np.full(30, 1 / 30, np.float32)), 1, 0)
    x0 = wl.pool.x.clone()
    _, residual = wl.step(np.array([False, True]))
    assert residual.shape == (3, 2) and residual.dtype == np.float32
    assert (residual[:, 0] == RES_INIT).all() and (residual[:, 1] < RES_INIT).all()
    torch.testing.assert_close(wl.pool.x[0], x0[0], rtol=0, atol=0)
    assert not torch.equal(wl.pool.x[1], x0[1])


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------


def _queues(R, seed):
    rng = np.random.default_rng(seed)
    q = []
    for i in range(int(rng.integers(1, 12))):
        sla = None if rng.random() < 0.3 else int(rng.integers(1, 40))
        q.append(R(id=int(rng.integers(0, 1000)) * 20 + i, arrival=int(rng.integers(0, 80)),
                   priority=int(rng.integers(0, 3)), sla=sla))
    return q


@pytest.mark.parametrize("name", ["fcfs", "priority", "sla_edf", "sla_edf:8"])
@pytest.mark.parametrize("gated", [False, True])
def test_scheduler_select_matches_reference(name, gated):
    ours, ref = get_scheduler(name), ref_get_scheduler(name)
    for seed in range(20):
        rng = np.random.default_rng(seed)
        now = 80 + int(rng.integers(0, 60))
        free = sorted(rng.choice(8, size=int(rng.integers(1, 6)), replace=False).tolist())
        gate = (lambda r: r.id % 3 != 0) if gated else None
        got = [(r.id, s) for r, s in ours.select(_queues(Request, seed), free, now, gate)]
        want = [(r.id, s) for r, s in ref.select(_queues(RefRequest, seed), free, now, gate)]
        assert got == want, (name, seed)


def test_sla_edf_parameter_and_bounds():
    assert get_scheduler("sla_edf").max_wait == 64
    assert get_scheduler("sla_edf:8").max_wait == 8
    with pytest.raises(ValueError, match="max_wait"):
        get_scheduler("sla_edf:0")
    with pytest.raises(ValueError, match="takes no"):
        get_scheduler("fcfs:3")
    with pytest.raises(ValueError, match="unknown scheduler"):
        get_scheduler("lifo")
    # a request waiting max_wait ticks goes ahead of every deadline
    q = [Request(id=0, arrival=10, sla=1), Request(id=1, arrival=0, sla=None)]
    assert [r.id for r in get_scheduler("sla_edf:8").order(q, 12)] == [1, 0]
    assert [r.id for r in get_scheduler("sla_edf").order(q, 12)] == [0, 1]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_queues_the_reference_clis_fixedpoint_requests(monkeypatch, capsys):
    """At the same seed the port's CLI queues the payloads, budgets,
    priorities and SLAs the reference CLI queues, and rounds --n alike."""
    from repro.launch import serve as ref_cli
    from repro_torch.launch import serve as cli

    class _Captured(Exception):
        pass

    class _Engine:
        def __init__(self, workload, cfg):
            pass

        def run(self, reqs):
            raise _Captured(reqs)

    monkeypatch.setattr(ref_cli, "make_workload", lambda *a, **k: None)
    monkeypatch.setattr(ref_cli, "ServeEngine", _Engine)
    argv = ["--continuous", "--workload", "fixedpoint_solve", "--requests", "5", "--n", "40",
            "--dp", "3", "--gen", "77", "--seed", "3"]
    with pytest.raises(_Captured) as got:
        ref_cli.main(argv)
    ref_reqs = got.value.args[0]
    ref_out = capsys.readouterr().out
    monkeypatch.setattr(cli, "ServeEngine", _Engine)
    with pytest.raises(_Captured) as got:
        cli.main(argv + ["--device", "cpu"])
    ours = got.value.args[0]
    assert "rounding --n 40 up to 42" in ref_out
    assert "rounding --n 40 up to 42" in capsys.readouterr().out
    assert len(ours) == len(ref_reqs) == 5
    for a, b in zip(ours, ref_reqs):
        assert (a.id, a.arrival, a.max_new, a.priority, a.sla, a.eps) == (
            b.id, b.arrival, b.max_new, b.priority, b.sla, b.eps)
        np.testing.assert_array_equal(a.payload, b.payload)


@pytest.mark.parametrize("solver", ["d_iteration", "jacobi_dense"])
def test_cli_serves_fixedpoint_on_cpu(solver, capsys):
    from repro_torch.launch import serve

    eng = serve.main(["--continuous", "--workload", "fixedpoint_solve", "--solver", solver,
                      "--n", "60", "--dp", "3", "--requests", "4", "--scheduler", "priority",
                      "--eps", "1e-5", "--device", "cpu"])
    s = eng.summary()
    assert s["completed"] == 4 and s["converged"] == 4
    assert "converged 4/4" in capsys.readouterr().out
