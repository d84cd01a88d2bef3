"""The engine's collective layer against the reference: the paper's
message and step counts, the per-stage message table and its per-tick
attribution, and the lane-batched step of the non-blocking plan (every
lane at its own stage) against the reference's ``vmap`` of its step.
Integers and maxima, so everything is held exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.asynchrony.engine import _stage_message_table  # noqa: E402
from repro.asynchrony.protocols import _stage_msgs as ref_stage_msgs  # noqa: E402
from repro.collectives import plans as ref_plans  # noqa: E402
from repro.collectives import schedules as ref_schedules  # noqa: E402
from repro_torch.asynchrony import AsyncConfig, make_solver, run  # noqa: E402
from repro_torch.asynchrony.protocols import _stage_msgs  # noqa: E402
from repro_torch.collectives import plans, schedules  # noqa: E402


@pytest.mark.parametrize("p", range(1, 34))
def test_schedule_counters_match_reference(p):
    stages = schedules.allreduce_schedule(p)
    ref = ref_schedules.allreduce_schedule(p)
    assert schedules.schedule_steps(stages) == ref_schedules.schedule_steps(ref)
    assert schedules.schedule_messages(stages) == ref_schedules.schedule_messages(ref)
    assert schedules.paper_message_count(p) == ref_schedules.paper_message_count(p)
    assert schedules.paper_step_count(p) == ref_schedules.paper_step_count(p)
    assert schedules.stage_message_table(p) == np.asarray(_stage_message_table(p)).tolist()


@pytest.mark.parametrize("p", [2, 3, 5, 8, 17])
def test_stage_attribution_matches_reference(p):
    """Each stage's bill, and the clamp past the last stage, tick by tick."""
    table = schedules.stage_message_table(p)
    ours = _stage_msgs(torch.tensor(table, dtype=torch.int32), torch.arange(len(table) + 4))
    ref = [int(ref_stage_msgs(_stage_message_table(p), jnp.int32(s)))
           for s in range(len(table) + 4)]
    assert ours.tolist() == ref
    assert sum(table) == schedules.paper_message_count(p)


@pytest.mark.parametrize("p", [2, 3, 5, 6, 8])
def test_lane_batched_step_matches_reference_vmap(p):
    """Lanes start at every stage of the cycle (and again), each with its
    own buffer and contribution; both sides step them together for two
    cycles."""
    plan = plans.allreduce_plan(p=p, op="max")
    ref_plan = ref_plans.allreduce_plan(schedule="mrd", p=p, op="max")
    S = plan.cycle_length()
    lanes = 2 * S + 1
    rng = np.random.default_rng(p)
    buf = rng.standard_normal((lanes, p)).astype(np.float32)
    ref_state = {"stage": jnp.asarray(np.arange(lanes) % S, jnp.int32), "buf": jnp.asarray(buf),
                 "result": jnp.zeros((lanes, p), jnp.float32),
                 "flag": jnp.zeros((lanes,), jnp.bool_), "cycles": jnp.zeros((lanes,), jnp.int32)}
    state = {"stage": torch.tensor(np.arange(lanes) % S, dtype=torch.int32),
             "buf": torch.from_numpy(buf.copy()), "result": torch.zeros((lanes, p)),
             "flag": torch.zeros(lanes, dtype=torch.bool),
             "cycles": torch.zeros(lanes, dtype=torch.int32)}
    ref_step = jax.jit(jax.vmap(ref_plan.step))
    for _ in range(2 * S + 1):
        value = rng.standard_normal((lanes, p)).astype(np.float32)
        ref_state = ref_step(ref_state, jnp.asarray(value))
        state = plan.step_lanes(state, torch.from_numpy(value))
        for k in ("stage", "buf", "result", "flag", "cycles"):
            np.testing.assert_array_equal(state[k].numpy(), np.asarray(ref_state[k]), err_msg=k)
    assert state["cycles"].min() >= 1


def test_lane_batched_step_at_one_rank():
    """p = 1 has no stage: every call completes a cycle in every lane."""
    plan = plans.allreduce_plan(p=1, op="max")
    state = plan.init_lanes(torch.zeros((3, 1)))
    value = torch.tensor([[1.0], [2.0], [3.0]])
    state = plan.step_lanes(state, value)
    assert state["flag"].all() and state["cycles"].tolist() == [1, 1, 1]
    assert torch.equal(state["result"], value)


@pytest.mark.parametrize("p", [2, 3, 5])
def test_sync_protocol_charges_paper_count_per_cycle(p):
    """The synchronous baseline completes one blocking cycle per tick, so
    ``messages_coll == ticks x paper_message_count(p)``."""
    fp = make_solver("poisson1d", n=24 * p, shift=0.5, seed=0)
    res = run(fp, AsyncConfig(p=p, detection="sync", max_ticks=50000, eps=1e-5), device="cpu")
    assert res.detected
    assert res.messages_coll == res.ticks * schedules.paper_message_count(p)


@pytest.mark.parametrize("p", [3, 5, 8])
def test_inexact_protocol_bills_one_stage_per_tick(p):
    """``inexact`` advances the reduction one stage a tick and bills that
    stage's messages: the total lies between ticks x the smallest and the
    largest stage (equal for a power of two)."""
    table = schedules.stage_message_table(p)
    fp = make_solver("poisson1d", n=24 * p, shift=0.5, seed=0)
    res = run(fp, AsyncConfig(p=p, detection="inexact", max_ticks=50000, eps=1e-5), device="cpu")
    assert res.detected
    assert res.ticks * min(table) <= res.messages_coll <= res.ticks * max(table)
    if p & (p - 1) == 0:
        assert res.messages_coll == res.ticks * p
