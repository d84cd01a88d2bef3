"""The port's MRD schedule, plan state machine and termination protocol
against the reference's.

Integers and control decisions must match exactly: stage tables, the
non-blocking plan's ``flag`` sequence, and ``eos_maxlen`` retire masks
tick by tick.  The reduced inputs are small integers in fp32, so sums and
maxima match exactly too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.collectives import plans as ref_plans  # noqa: E402
from repro.collectives import schedules as ref_schedules  # noqa: E402
from repro.serving import termination as ref_term  # noqa: E402
from repro_torch.collectives import plans, schedules  # noqa: E402
from repro_torch.serving import termination  # noqa: E402


@pytest.mark.parametrize("p", range(1, 18))
def test_mrd_stage_table_matches_reference(p):
    ours = [(st.kind, st.pairs, st.distance) for st in schedules.allreduce_schedule(p)]
    ref = [(st.kind, st.pairs, st.distance) for st in ref_schedules.allreduce_schedule(p)]
    assert ours == ref
    assert schedules.pivot(p) == ref_schedules.pivot(p)


@pytest.mark.parametrize("p", range(2, 18))
def test_mrd_message_and_step_counts_are_the_papers(p):
    p0, mu0, extra = schedules.pivot(p)
    stages = schedules.get_schedule("mrd").phases(1)[0].stages(p)
    assert sum(len(st.pairs) for st in stages) == p0 * mu0 + 2 * extra
    assert len(stages) == mu0 + (2 if extra else 0)


@pytest.mark.parametrize("p", [1, 2, 3, 5, 6, 8])
@pytest.mark.parametrize("op", ["max", "sum"])
def test_plan_step_flags_and_results_match_reference(p, op):
    """Two cycles and a bit of init/step with a contribution that changes
    every call: flags, cycle counts and published results match exactly
    (integers, so sums are exact too)."""
    rng = np.random.default_rng(p)
    ours = plans.allreduce_plan(schedule="mrd", p=p, op=op)
    ref = ref_plans.allreduce_plan(schedule="mrd", p=p, op=op)
    assert ours.cycle_length() == ref.cycle_length()
    vals = rng.integers(-50, 50, size=(2 * ours.cycle_length() + 1, p, 5)).astype(np.float32)
    st = ours.init(torch.from_numpy(vals[0]))
    rst = ref.init(jnp.asarray(vals[0]))
    ref_step = jax.jit(ref.step)
    for v in vals:
        st = ours.step(st, torch.from_numpy(v))
        rst = ref_step(rst, jnp.asarray(v))
        assert st["flag"] == bool(rst["flag"])
        assert st["stage"] == int(rst["stage"])
        assert st["cycles"] == int(rst["cycles"])
        np.testing.assert_array_equal(st["result"].numpy(), np.asarray(rst["result"]))
        np.testing.assert_array_equal(st["buf"].numpy(), np.asarray(rst["buf"]))


@pytest.mark.parametrize("p", [2, 3, 5, 7, 12])
def test_plan_run_is_allreduce(p):
    rng = np.random.default_rng(10 + p)
    x = rng.integers(-9, 9, size=(p, 4)).astype(np.float32)
    for op, red in (("sum", np.sum), ("max", np.max), ("min", np.min)):
        out = plans.allreduce_plan(p=p, op=op).run(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(out, np.broadcast_to(red(x, axis=0), x.shape))
        ref = ref_plans.allreduce_plan(p=p, op=op).run(jnp.asarray(x))
        np.testing.assert_array_equal(out, np.asarray(ref))
    blocking = plans.allreduce_plan(p=p, op="sum").run_blocking(torch.from_numpy(x))
    np.testing.assert_array_equal(blocking.numpy(), np.broadcast_to(x.sum(0), x.shape))


def _signals(rng, slots, tick, state):
    """A random but consistent signal sequence: slots switch on/off, are
    re-admitted, hit EOS or their budget."""
    active, admit, new_tok, max_new, eos = state
    for s in range(slots):
        if not active[s] and rng.random() < 0.5:
            active[s], admit[s], new_tok[s] = True, tick, 1
            max_new[s], eos[s] = rng.integers(2, 7), rng.integers(-1, 4)
        elif active[s] and rng.random() < 0.1:
            active[s] = False
    new_tok[active] += 1
    tokens = rng.integers(0, 4, size=slots)
    return dict(tokens=tokens, new_tokens=new_tok.copy(), eos=eos.copy(),
                max_new=max_new.copy(), active=active.copy(), admit_tick=admit.copy(),
                tick=tick)


@pytest.mark.parametrize("dp", [1, 3, 5])
def test_eos_maxlen_retire_masks_match_reference_tick_by_tick(dp):
    slots, ticks = 6, 40
    rng = np.random.default_rng(dp)
    state = (np.zeros(slots, bool), np.zeros(slots, np.int64), np.zeros(slots, np.int64),
             np.ones(slots, np.int64), np.full(slots, -1, np.int64))
    ours, ref = termination.get_termination("eos_maxlen"), ref_term.get_termination("eos_maxlen")
    cfg, rcfg = termination.TerminationConfig(dp=dp), ref_term.TerminationConfig(dp=dp)
    st, rst = ours.init(cfg, slots, device="cpu"), ref.init(rcfg, slots)
    ref_tick = jax.jit(ref.tick, static_argnums=2)
    n_retired = 0
    for t in range(ticks):
        sig = _signals(rng, slots, t, state)
        tsig = termination.make_signals(
            **{k: (torch.from_numpy(np.asarray(v)) if k != "tick" else v) for k, v in sig.items()})
        rsig = ref_term.make_signals(
            **{k: jnp.asarray(v) for k, v in sig.items()},
            eps=jnp.zeros(slots, jnp.float32), residual=jnp.zeros((dp, slots), jnp.float32))
        st, retire = ours.tick(st, tsig, cfg)
        rst, rretire = ref_tick(rst, rsig, rcfg)
        np.testing.assert_array_equal(retire.numpy(), np.asarray(rretire))
        np.testing.assert_array_equal(st["certified"].numpy(), np.asarray(rst["certified"]))
        assert st["t_latch"] == int(rst["t_latch"])
        state[0][retire.numpy()] = False  # the engine deactivates retired slots
        n_retired += int(retire.sum())
    assert n_retired > 0
