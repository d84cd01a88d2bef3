"""The port's engine on its own, on the CPU: ``sweep`` against per-seed
``run`` bit for bit (every delay model, and a [3, 4] activity grid), the
delay models' fairness, the straggler's lag, the trace replaying its
source, convergence and exact detection's soundness, and results that do
not depend on how often the loop looks for finished lanes."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.asynchrony import (  # noqa: E402
    DELAY_MODELS,
    AsyncConfig,
    make_solver,
    resolve_delay_params,
    run,
    sweep,
)
from repro_torch.asynchrony.draws import CounterSource, Draw  # noqa: E402
from repro_torch.asynchrony import engine  # noqa: E402
from repro_torch.asynchrony.engine import _lane_params  # noqa: E402

FIELDS = ("detected", "ticks", "res_glb", "true_res", "kiter", "messages_p2p", "messages_coll",
          "x")


@pytest.fixture(scope="module")
def fp():
    return make_solver("poisson1d", n=96, shift=0.5, seed=0)


def _cfg(**kw):
    return AsyncConfig(**{**dict(p=4, detection="exact", eps=1e-5, max_ticks=50000, seed=1),
                          **kw})


def _assert_lane_is_run(sw, index, r):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(sw, f)[index]),
                                      np.asarray(getattr(r, f)), err_msg=f)


def test_registries():
    from repro_torch.asynchrony import DETECTION_PROTOCOLS, SOLVERS

    assert set(DELAY_MODELS) == {"bernoulli", "straggler", "heterogeneous", "bursty", "trace"}
    assert set(DETECTION_PROTOCOLS) == {"inexact", "exact", "oracle", "sync", "interval"}
    assert set(SOLVERS) == {"poisson1d", "poisson2d", "jacobi_dense", "richardson",
                            "d_iteration"}


@pytest.mark.parametrize("model", sorted(DELAY_MODELS))
def test_sweep_equals_run_bit_for_bit(fp, model):
    """Each lane of a sweep is the run with its seed and the sweep's delay
    parameters (a default trace is recorded under ``cfg.seed``)."""
    cfg = _cfg(delay_model=model)
    params = resolve_delay_params(fp, cfg)
    seeds = [0, 1, 2, 5]
    sw = sweep(fp, cfg, seeds, device="cpu")
    assert sw.ticks.shape == (4,) and sw.x.shape == (4, 96)
    for i, s in enumerate(seeds):
        r = run(fp, dataclasses.replace(cfg, seed=s), delay_params=params, device="cpu")
        _assert_lane_is_run(sw, i, r)


def test_sweep_grid_equals_run_bit_for_bit(fp):
    """A [G, S] = [3, 4] grid over bernoulli's activity: each lane is the
    run with its seed and activity, and no lane finishes later at higher
    activity on average."""
    cfg = _cfg()
    seeds = [0, 1, 2, 3]
    grid = {"activity": torch.tensor([0.3, 0.6, 0.9])}
    sw = sweep(fp, cfg, seeds, delay_params=grid, device="cpu")
    assert sw.ticks.shape == (3, 4) and sw.x.shape == (3, 4, 96) and sw.kiter.shape == (3, 4, 4)
    assert sw.detected.all() and (sw.true_res < cfg.eps).all()
    for g, act in enumerate(grid["activity"].tolist()):
        for i, s in enumerate(seeds):
            r = run(fp, dataclasses.replace(cfg, seed=s, activity=act), device="cpu")
            _assert_lane_is_run(sw, (g, i), r)
    assert sw.ticks[0].mean() >= sw.ticks[2].mean()


@pytest.mark.parametrize("protocol", ["exact", "inexact", "interval"])
def test_results_do_not_depend_on_how_often_the_loop_checks(fp, protocol, monkeypatch):
    cfg = _cfg(detection=protocol, delay_model="bursty")
    b = sweep(fp, cfg, [0, 1, 2], device="cpu")
    monkeypatch.setattr(engine, "CHECK_EVERY", 1)
    a = sweep(fp, cfg, [0, 1, 2], device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("p,max_delay,force_every", [(3, 1, 2), (4, 3, 5), (7, 2, 3)])
@pytest.mark.parametrize("model", sorted(DELAY_MODELS))
def test_every_model_is_fair(model, p, max_delay, force_every):
    """Over 48 ticks and 6 lanes: delays are int32 in [0, max_delay], and a
    worker idle for ``force_every`` ticks is active."""
    cfg = _cfg(p=p, max_delay=max_delay, force_every=force_every, delay_model=model,
               activity=0.2)
    dm = DELAY_MODELS[model]
    lanes = 6
    params = _lane_params(resolve_delay_params(None, cfg), 0, lanes, "cpu")
    state = dm.init_state(p, lanes, "cpu")
    seed = torch.arange(lanes)
    last = torch.zeros((lanes, p), dtype=torch.int32)
    for t in range(1, 49):
        tick = torch.full((lanes,), t, dtype=torch.int32)
        active, delays, state = dm.sample(params, state, tick, Draw(CounterSource(), seed, tick),
                                          last, p=p, max_delay=max_delay,
                                          force_every=force_every)
        assert delays.dtype == torch.int32 and delays.shape == (lanes, p, p)
        assert int(delays.min()) >= 0 and int(delays.max()) <= max_delay
        assert active.dtype == torch.bool
        assert active[t - last >= force_every].all()
        last = torch.where(active, tick[:, None], last)
        assert (t - last < force_every).all()


def test_straggler_model_actually_lags(fp):
    cfg = _cfg(delay_model="straggler", detection="oracle", force_every=10)
    n_slow = int(resolve_delay_params(fp, cfg)["n_slow"])
    r = run(fp, cfg, device="cpu")
    assert r.kiter[:n_slow].mean() < 0.6 * r.kiter[n_slow:].mean()


def test_trace_replays_its_source_model(fp):
    """The default trace records bernoulli from the same draws, so
    replaying it gives the bernoulli run exactly."""
    r_b = run(fp, _cfg(delay_model="bernoulli"), device="cpu")
    r_t = run(fp, _cfg(delay_model="trace"), device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(r_t, f)), np.asarray(getattr(r_b, f)),
                                      err_msg=f)


@pytest.mark.parametrize("model", sorted(DELAY_MODELS))
def test_every_model_converges_with_exact_detection(fp, model):
    r = run(fp, _cfg(delay_model=model), device="cpu")
    assert r.detected, f"exact detector never fired under {model}"
    assert r.true_res < 1e-5


@pytest.mark.parametrize("p,max_delay", [(3, 1), (5, 3), (8, 2)])
def test_exact_never_certifies_an_unconverged_solution(p, max_delay):
    fp = make_solver("poisson1d", n=24 * p, shift=0.5, seed=p)
    sw = sweep(fp, _cfg(p=p, max_delay=max_delay, activity=0.5), list(range(6)), device="cpu")
    assert sw.detected.all()
    assert (sw.true_res < 1e-5).all() and (sw.res_glb < 1e-5).all()
    assert (sw.res_glb == sw.true_res).all()  # certified on the returned x̄ itself


def test_sync_runs_without_draws(fp):
    """``sync`` pins full activity and zero delays: a table source, which
    serves no bits, runs it, and every worker iterates every tick."""
    from repro_torch.asynchrony.draws import TableSource

    r = run(fp, _cfg(detection="sync"), source=TableSource([[0] * 4], [0]), device="cpu")
    assert r.detected and (r.kiter == r.ticks).all()
