"""The port's elastic trainer against the reference's, on the CPU, stacked
rows (the ``("data",)`` worlds are ``test_torch_elastic_world.py``'s).

- (a) The resize hooks fed the reference's states: ``local_sgd``,
  ``mrd_leaf``, ``gspmd``, ``mrd_zero1``, ``mrd_paper`` and
  ``compressed`` (a random state in the reference's layout, several
  buckets, at the three resizes of the headline script) and
  ``ConvergenceMonitor.migrate_rows``: the port's output equals the
  reference hook's exactly (the hooks only move data).  The engine
  protocols' ``migrate`` keeps the reference's latches and shapes.
- (b) The reference's five chaos scenarios
  (``tests/test_chaos_elastic.py``) on stacked rows at the smoke config:
  the kill-join 4 -> 3 -> 5 -> 4, the ``compressed`` grow 3 -> 5 without
  a checkpointer, the straggler drain and the silent kill, ``overlap``,
  and the random scripts of seeds 1 and 7: each run equals its
  ``oracle_replay`` (``tests/torch_chaos.py``) bit for bit, losses,
  params, optimizer rows and monitor rows.
- (c) One recording of the reference's ``ElasticTrainer`` on the
  headline script (a subprocess with 8 forced host devices; test-side
  wrappers record the state before and after each ``migrate_state`` and
  before each step): the port's trainer, from the reference's initial
  state on its batches, takes the same resize events; the port's
  ``migrate_state`` of each recorded state before a resize equals the
  recorded one after it exactly; the losses are within
  ``tests/test_torch_train_modes.py``'s 1e-5, a segment that drifts past
  it held teacher-forced (each step from the reference's state before it).
- (d) ``init_or_restore`` at another extent restores the params, the step
  and the data cursor and restarts the optimizer from the restored params
  (``local_sgd``: the first replica onto every row); the reference's fault
  e is not copied: the first step after the restore starts from the
  restored params.  An opaque step factory resizes through the checkpoint.
- (e) The train CLI's ``--elastic-policy`` with no event equals the plain
  loop bit for bit; an unknown policy is refused; ``--tp`` 2 runs in a
  world of 4 (``gspmd``, checkpointed) and is refused outside one.
- (f) ``CollectivePlan.invalidate`` drops the memo and the plan derives it
  again; the live-plan registry holds weak references (a dropped plan is
  freed) and prunes the dead ones as plans are built; ``recover`` restores
  the latest checkpoint onto a template of another extent;
  ``handle_failure`` shrinks at once through the resize hook;
  ``parse_chaos`` reads the CLIs' event specs.
"""

import copy
import gc
import json
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.asynchrony import protocols as ref_protocols  # noqa: E402
from repro.distributed.gradsync import common as ref_common  # noqa: E402
from repro.distributed.gradsync import local_sgd as ref_local_sgd  # noqa: E402
from repro.distributed.gradsync import mrd_leaf as ref_mrd_leaf  # noqa: E402
from repro.distributed.gradsync import gspmd as ref_gspmd  # noqa: E402
from repro.distributed.gradsync import mrd_zero1 as ref_zero1  # noqa: E402
from repro.distributed.gradsync.common import TrainConfig as RefTrainConfig  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch.asynchrony.protocols import (  # noqa: E402
    DETECTION_PROTOCOLS,
    RES_INIT,
    get_protocol,
)
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.collectives import plans  # noqa: E402
from repro_torch.collectives.buckets import tree_flatten  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.distributed import gradsync  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.distributed.gradsync.mrd_zero1 import zero1_masters_from_params  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.runtime import ElasticConfig, ElasticTrainer, HeartbeatConfig, recover  # noqa: E402
from repro_torch.runtime.chaos import Unstall, parse_chaos  # noqa: E402
from torch_chaos import (  # noqa: E402
    KILL_JOIN_TRAJECTORY,
    ChaosScript,
    Join,
    Kill,
    Stall,
    assert_params_bit_identical,
    kill_join_script,
    oracle_replay,
)
from torch_train_ref import flat, one_thread, tree  # noqa: E402,F401

ARCH = "llama3.2-1b"
HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
LOSS_ATOL = 1e-5  # tests/test_torch_train_modes.py's (test_torch_train_families.check_metrics)
HEADLINE_KEEPS = [(4, (0, 1, 3)), (3, (0, 1, 2, None, None)), (5, (0, 2, 3, 4))]


def make_tcfg(**kw):
    """The reference chaos suite's ``make_tcfg``."""
    kw.setdefault("grad_sync", "mrd_zero1")
    kw.setdefault("monitor", True)
    kw.setdefault("monitor_mode", "interval")
    kw.setdefault("monitor_threshold", 1e-6)
    return step_lib.TrainConfig(
        microbatches=1, remat="none",
        optimizer=OptimizerConfig(lr=5e-3, schedule="const", warmup_steps=0), **kw)


# ---------------------------------------------------------------------------
# (a) the hooks on the reference's states
# ---------------------------------------------------------------------------


class _FakeMesh:
    """What the reference's hooks read of a mesh: its axis names and sizes."""

    def __init__(self, dp: int):
        self.axis_names = ("data",)
        self.shape = {"data": dp}


def _ref_state(mode: str, dp: int, seed: int, bucket_bytes: int) -> dict:
    """A random train state in the reference's layout at ``dp``: the smoke
    params, the mode's optimizer (ZeRO-1 rows, EF rows, trees, replicas)
    and the monitor's rows with random values, latches and windows."""
    rcfg = ref_registry.get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    params = {k: v for k, v in flat(ref_tf.init_params(rcfg, jax.random.PRNGKey(seed))).items()}

    def rand(shape):
        return rng.standard_normal(shape).astype(np.float32)

    def nest(d):
        out: dict = {}
        for k, v in d.items():
            node = out
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return out

    ptree = nest({k: rand(v.shape).astype(v.dtype) for k, v in params.items()})
    state = {"params": ptree, "step": np.asarray(3, np.int32)}
    if mode in ("mrd_zero1", "compressed", "mrd_paper"):
        pshape = jax.eval_shape(
            lambda: ref_tf.init_params(rcfg, jax.random.PRNGKey(0)))
        layout, p0 = ref_zero1.zero1_layout(pshape, _FakeMesh(dp), ("data",),
                                            bucket_bytes=bucket_bytes)
        m = layout.total_padded if mode == "mrd_paper" else layout.total_padded // p0
        state["opt"] = {k: rand((dp, m)) for k in ("master", "mu", "nu")}
        if mode == "mrd_paper":  # replicated rows, as the step keeps them
            state["opt"] = {k: np.broadcast_to(v[:1], v.shape).copy()
                            for k, v in state["opt"].items()}
        if mode == "compressed":
            state["opt"]["ef"] = rand((dp, layout.total_padded))
    elif mode == "local_sgd":
        rows = {k: rand((dp,) + v.shape).astype(v.dtype) for k, v in params.items()}
        state["params"] = nest(rows)
        state["opt"] = {k: nest({p: rand((dp,) + v.shape) for p, v in params.items()})
                        for k in ("master", "mu", "nu")}
    else:
        state["opt"] = {k: nest({p: rand(v.shape) for p, v in params.items()})
                        for k in ("master", "mu", "nu")}
    if mode != "local_sgd":
        mon = ref_common.monitor_rows_init(ref_common.build_monitor(
            RefTrainConfig(monitor=True, monitor_mode="interval"),
            type("R", (), {"dp_axes": ("data",)})()), dp)
        mon = jax.tree.map(np.asarray, mon)
        mon["value"] = rand((dp,))
        mon["done"] = rng.random(dp) < 0.5
        mon["m"]["win"] = rand(mon["m"]["win"].shape)
        mon["nb"]["stage"] = np.full((dp,), 1, np.int32)
        mon["nb"]["buf"] = rand((dp,))
        state["monitor"] = mon
    return state


REF_HOOKS = {
    "mrd_zero1": lambda *a: ref_zero1.resize_zero1(*a),
    "compressed": lambda *a: ref_zero1.resize_zero1(*a),
    "mrd_paper": lambda *a: ref_zero1.resize_zero1(*a, paper_mode=True),
    "mrd_leaf": ref_mrd_leaf.resize,
    "local_sgd": ref_local_sgd.resize,
    "gspmd": ref_gspmd.resize,
}


@pytest.mark.parametrize("mode", sorted(REF_HOOKS))
def test_resize_hooks_equal_the_references_on_its_states(mode):
    cfg, rcfg = registry.get_smoke_config(ARCH), ref_registry.get_smoke_config(ARCH)
    bucket_bytes = 1 << 16  # several buckets
    for j, (old_dp, keep) in enumerate(HEADLINE_KEEPS):
        new_dp = len(keep)
        ref = _ref_state(mode, old_dp, seed=j, bucket_bytes=bucket_bytes)
        rtcfg = RefTrainConfig(grad_sync=mode, monitor=mode != "local_sgd",
                               monitor_mode="interval", bucket_bytes=bucket_bytes)
        want = REF_HOOKS[mode](rcfg, rtcfg, _FakeMesh(old_dp), _FakeMesh(new_dp),
                               jax.tree.map(jnp.asarray, ref), keep)
        tcfg = make_tcfg(grad_sync=mode, monitor=mode != "local_sgd", bucket_bytes=bucket_bytes)
        got = gradsync.migrate_state(cfg, tcfg, tuple(range(old_dp)), tuple(range(new_dp)),
                                     convert.train_state_from_reference(ref, cfg, "cpu"), keep)
        got = flat(jax_free(convert.train_state_to_reference(got)))
        want = flat(jax.tree.map(np.asarray, want))
        assert sorted(got) == sorted(want), (mode, j)
        for k, v in want.items():
            assert got[k].shape == v.shape and np.array_equal(got[k], v), (mode, j, k)


def jax_free(tree):
    """A port tree of tensors as numpy arrays (bf16 as float32)."""
    if isinstance(tree, dict):
        return {k: jax_free(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
    return np.asarray(tree)


@pytest.mark.parametrize("keep", [(1, 3, None), (0, 2, 3), (0, 1, 2, 3, None, None)])
def test_monitor_migrate_rows_equals_the_references(keep):
    ref = _ref_state("mrd_leaf", 4, seed=7, bucket_bytes=1 << 14)["monitor"]
    rmon = ref_protocols.ConvergenceMonitor(axis_name="data", threshold=1e-6, mode="interval")
    want = flat(jax.tree.map(np.asarray, rmon.migrate_rows(
        jax.tree.map(jnp.asarray, ref), keep)))
    mon = step_lib.build_monitor(make_tcfg(), len(keep))
    got = mon.migrate_rows(convert.monitor_from_reference(ref, "cpu"), keep)
    got = flat(jax_free(convert.train_state_to_reference(
        {"params": {}, "opt": {}, "step": 0, "monitor": got})["monitor"]))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v.astype(got[k].dtype)), k


class _Cfg:
    max_delay = 3
    window = 0
    eps = 1e-6


@pytest.mark.parametrize("name", sorted(DETECTION_PROTOCOLS))
@pytest.mark.parametrize("keep", [(0, 2, 3), (0, 1, 2, 3, None, None)])
def test_protocol_migrate_keeps_latches_and_shapes(name, keep):
    """The reference's ``test_protocol_migrate_shapes_and_latches`` and its
    per-protocol cases, on the port's lane-batched state (2 lanes)."""
    proto = get_protocol(name)
    st = proto.init(4, 6, _Cfg(), 2, "cpu")
    st["res_norm"] = torch.tensor([0.125, 0.5])
    st["detected"] = torch.tensor([True, False])
    if "res_loc" in st:
        st["res_loc"] = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    if "win" in st:
        st["win"] = torch.arange(st["win"].numel(), dtype=torch.float32).reshape(st["win"].shape)
    if "xbar" in st:
        st["xbar"] = torch.arange(48, dtype=torch.float32).reshape(2, 24)
    new_p = len(keep)
    m = 24 // new_p if name == "exact" and 24 % new_p == 0 else 6
    out = proto.migrate(st, keep, new_p, m, _Cfg())
    fresh = proto.init(new_p, m, _Cfg(), 2, "cpu")

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else (
            tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else type(t)

    assert shapes(out) == shapes(fresh)
    assert out["res_norm"].tolist() == [0.125, 0.5] and out["detected"].tolist() == [True, False]
    if name in ("inexact", "interval"):  # the latches follow their workers
        want = [[RES_INIT if k is None else float(lane * 4 + k) for k in keep] for lane in range(2)]
        assert out["res_loc"].tolist() == torch.tensor(want).tolist()
    if "win" in out:
        for i, k in enumerate(keep):
            col = out["win"][:, :, i]
            assert torch.equal(col, torch.full_like(col, RES_INIT) if k is None
                               else st["win"][:, :, k])
    if "nb" in out:
        assert out["nb"]["stage"].tolist() == [0, 0] and not out["nb"]["flag"].any()
    if name == "exact":
        assert out["mode"].tolist() == [0, 0] and not out["snap"]["in_progress"].any()
        if m * new_p == 24:
            assert torch.equal(out["xbar"], st["xbar"])


# ---------------------------------------------------------------------------
# (b) the reference's chaos scenarios against their oracle replays
# ---------------------------------------------------------------------------


def run_chaos(tcfg, dcfg, ids, script, steps, policy, hb=None):
    cfg = registry.get_smoke_config(ARCH)
    tr = ElasticTrainer(tuple(ids), (cfg, tcfg), lambda m: SyntheticPipeline(cfg, dcfg, "cpu"),
                        cfg=ElasticConfig(policy=policy, heartbeat=hb or HeartbeatConfig()),
                        device="cpu")
    state = tr.init_or_restore(torch.Generator().manual_seed(0))
    state, losses = tr.run(state, steps, events=script)
    return tr, state, losses


def check_vs_oracle(tr, state, losses, tcfg, dcfg, ids, steps, tag):
    cfg = registry.get_smoke_config(ARCH)
    o_state, o_losses = oracle_replay(cfg, tcfg, dcfg, ids, tr.resizes, steps)
    assert losses == o_losses, (tag, losses, o_losses)
    for part in ("params", "opt", "monitor"):
        if part in o_state:
            assert_params_bit_identical(state[part], o_state[part], f"{tag}:{part}")
    assert state["step"] == o_state["step"] == steps


def traj(tr):
    return [(e.kind, e.old_dp, e.new_dp) for e in tr.resizes]


def test_chaos_kill_join_crossing_non_p2_extents():
    dcfg = DataConfig(batch=60, seq_len=8, seed=0)  # 4, 3 and 5 divide 60
    tcfg = make_tcfg()
    tr, state, losses = run_chaos(tcfg, dcfg, [0, 1, 2, 3], kill_join_script(), 10,
                                  "grow_on_join")
    assert traj(tr) == KILL_JOIN_TRAJECTORY and [e.step for e in tr.resizes] == [2, 4, 7]
    assert tr.restores == 0 and not any(e.restored_from_checkpoint for e in tr.resizes)
    assert [e.device_ids for e in tr.resizes] == [(0, 1, 3), (0, 1, 3, 2, 4), (0, 3, 2, 4)]
    assert len(losses) == 10 and len(tr.resize_times) == 3
    check_vs_oracle(tr, state, losses, tcfg, dcfg, [0, 1, 2, 3], 10, "kill-join")


def test_chaos_compressed_grow_3_to_5_without_checkpoint():
    dcfg = DataConfig(batch=15, seq_len=16, seed=0)
    tcfg = make_tcfg(grad_sync="compressed")  # the EF residuals ride along
    tr, state, losses = run_chaos(tcfg, dcfg, [0, 1, 2], ChaosScript([Join(3, (3, 4))]), 7,
                                  "grow_on_join")
    assert traj(tr) == [("grow", 3, 5)] and tr.restores == 0 and tr.ck is None
    assert "ef" in state["opt"] and state["opt"]["ef"].shape[0] == 5
    assert not state["opt"]["ef"][3:].eq(0).all()  # the joiners sent since the grow
    check_vs_oracle(tr, state, losses, tcfg, dcfg, [0, 1, 2], 7, "grow35")


def test_chaos_straggler_drain_and_silent_kill():
    dcfg = DataConfig(batch=12, seq_len=16, seed=0)
    tcfg = make_tcfg()
    hb = HeartbeatConfig(straggler_factor=3.0, evict_after_straggler_steps=2, timeout_s=1e9)
    tr, state, losses = run_chaos(tcfg, dcfg, [0, 1, 2, 3], ChaosScript([Stall(1, 3, 10.0)]),
                                  6, "drain_straggler", hb=hb)
    assert traj(tr) == [("shrink", 4, 3)] and "straggler" in tr.resizes[0].reason
    check_vs_oracle(tr, state, losses, tcfg, dcfg, [0, 1, 2, 3], 6, "drain")
    # a partition at step 1, timeout 2.5 on the injected clock: the last
    # heartbeat at now=1, heartbeats at now=step+1, detected before step 3
    tr, state, losses = run_chaos(tcfg, dcfg, [0, 1, 2, 3],
                                  ChaosScript([Kill(1, 0, silent=True)]), 6,
                                  "shrink_on_failure", hb=HeartbeatConfig(timeout_s=2.5))
    assert traj(tr) == [("shrink", 4, 3)] and tr.resizes[0].step == 3
    check_vs_oracle(tr, state, losses, tcfg, dcfg, [0, 1, 2, 3], 6, "silent")


def test_chaos_kill_join_with_overlap():
    dcfg = DataConfig(batch=60, seq_len=8, seed=0)
    script = [Kill(2, 2), Join(4, (2, 4))]
    tcfg_o = make_tcfg(overlap=True)
    tr, state, losses = run_chaos(tcfg_o, dcfg, [0, 1, 2, 3], ChaosScript(list(script)), 8,
                                  "grow_on_join")
    assert [(e.old_dp, e.new_dp) for e in tr.resizes] == [(4, 3), (3, 5)]
    _, state_b, losses_b = run_chaos(make_tcfg(overlap=False), dcfg, [0, 1, 2, 3],
                                     ChaosScript(list(script)), 8, "grow_on_join")
    assert losses == losses_b
    assert_params_bit_identical(state["params"], state_b["params"], "ovl")
    assert_params_bit_identical(state["opt"], state_b["opt"], "ovl:opt")
    check_vs_oracle(tr, state, losses, tcfg_o, dcfg, [0, 1, 2, 3], 8, "overlap-chaos")


@pytest.mark.parametrize("seed", [1, 7])
def test_chaos_random_seeded_scripts(seed):
    dcfg = DataConfig(batch=60, seq_len=8, seed=0)  # extents 2..6 divide 60
    tcfg = make_tcfg()
    script = ChaosScript.random(seed, n_steps=9, initial_devices=[0, 1, 2, 3],
                                spare_devices=[4, 5], min_extent=2, max_events=3)
    tr, state, losses = run_chaos(tcfg, dcfg, [0, 1, 2, 3], script, 9, "grow_on_join")
    assert tr.restores == 0 and tr.resizes
    check_vs_oracle(tr, state, losses, tcfg, dcfg, [0, 1, 2, 3], 9, f"rand{seed}")


@pytest.mark.parametrize("mode", ["mrd_paper", "mrd_leaf", "local_sgd", "gspmd"])
def test_every_mode_survives_the_kill_join_script(mode):
    """The other modes' hooks in the trainer: the headline trajectory, bit
    for bit its oracle replay (under ``local_sgd`` the joiners' replicas
    are the first survivor's, then averaged at the next boundary)."""
    dcfg = DataConfig(batch=60, seq_len=8, seed=0)
    tcfg = make_tcfg(grad_sync=mode, monitor=mode != "local_sgd", local_sync_every=3)
    tr, state, losses = run_chaos(tcfg, dcfg, [0, 1, 2, 3], kill_join_script(), 10,
                                  "grow_on_join")
    assert traj(tr) == KILL_JOIN_TRAJECTORY
    check_vs_oracle(tr, state, losses, tcfg, dcfg, [0, 1, 2, 3], 10, mode)


# ---------------------------------------------------------------------------
# (d) init_or_restore at another extent; fault e not copied
# ---------------------------------------------------------------------------


def _trainer(dp, tcfg, ck=None, factory=None):
    cfg = registry.get_smoke_config(ARCH)
    dcfg = DataConfig(batch=12, seq_len=16, seed=0)
    return ElasticTrainer(tuple(range(dp)), factory or (cfg, tcfg),
                          lambda m: SyntheticPipeline(cfg, dcfg, "cpu"), checkpointer=ck,
                          cfg=ElasticConfig(policy="shrink_on_failure", ckpt_every=2),
                          device="cpu")


@pytest.mark.parametrize("mode", ["mrd_zero1", "local_sgd"])
def test_init_or_restore_at_another_extent(tmp_path, mode):
    tcfg = make_tcfg(grad_sync=mode, monitor=mode != "local_sgd", bucket_bytes=1 << 14)
    ck = Checkpointer(str(tmp_path))
    tr = _trainer(3, tcfg, ck)
    state, _ = tr.run(tr.init_or_restore(torch.Generator().manual_seed(0)), 3)
    ck.wait()
    saved = state["params"]
    tr4 = _trainer(4, tcfg, Checkpointer(str(tmp_path)))
    st4 = tr4.init_or_restore(torch.Generator().manual_seed(5))
    assert st4["step"] == tr4.step == 3 and tr4.pipe.step == 3
    if mode == "local_sgd":  # the first saved replica on every row
        for a, b in zip(tree_flatten(st4["params"])[0], tree_flatten(saved)[0]):
            assert all(torch.equal(a[r], b[0]) for r in range(4))
        assert not any(leaf.any() for leaf in tree_flatten(st4["opt"]["mu"])[0])
        return
    assert_params_bit_identical(st4["params"], saved, "restored params")
    masters = zero1_masters_from_params(st4["params"], 4, bucket_bytes=1 << 14)
    assert torch.equal(st4["opt"]["master"], masters)
    assert not st4["opt"]["mu"].any() and not st4["opt"]["nu"].any()


def test_first_step_after_a_restore_starts_from_the_restored_params(tmp_path):
    """The reference's fault e: its ``init_or_restore`` keeps the fresh
    init's masters, which the ZeRO-1 step writes back into the params.
    Here the step after the restore equals a plain step from the restored
    params with masters of them, and differs from one from the fresh
    masters."""
    tcfg = make_tcfg(bucket_bytes=1 << 14)
    ck = Checkpointer(str(tmp_path))
    tr = _trainer(3, tcfg, ck)
    tr.run(tr.init_or_restore(torch.Generator().manual_seed(0)), 2)
    ck.wait()
    tr2 = _trainer(4, tcfg, Checkpointer(str(tmp_path)))
    st = tr2.init_or_restore(torch.Generator().manual_seed(9))
    step4 = step_lib.make_train_step(registry.get_smoke_config(ARCH), tcfg, dp=4, device="cpu")
    fresh = step4.init_state(torch.Generator().manual_seed(9))
    faulty = {**fresh, "params": st["params"], "step": st["step"]}  # the reference's state
    batch = SyntheticPipeline(registry.get_smoke_config(ARCH),
                              DataConfig(batch=12, seq_len=16, seed=0), "cpu")
    batch.load_state_dict({"step": 2, "seed": 0})
    b = batch.next_batch()
    plain = {**fresh, "params": st["params"], "opt": step4.opt_from_params(st["params"]),
             "step": st["step"]}
    want, _ = step4(plain, b)
    bad, _ = step4(faulty, b)
    got, _ = tr2.run(st, 1)
    assert_params_bit_identical(got["params"], want["params"], "after the restore")
    assert not torch.equal(bad["params"]["embed"], want["params"]["embed"])


def test_an_opaque_factory_resizes_through_the_checkpoint(tmp_path):
    cfg = registry.get_smoke_config(ARCH)
    tcfg = make_tcfg(bucket_bytes=1 << 14)
    tr = _trainer(4, tcfg, Checkpointer(str(tmp_path)),
                  factory=gradsync.make_step_factory(cfg, tcfg, device="cpu"))
    state = tr.init_or_restore(torch.Generator().manual_seed(0))
    state, losses = tr.run(state, 6, fail_at={3: {0}})
    ev = tr.resizes[0]
    assert (ev.kind, ev.old_dp, ev.new_dp, ev.step) == ("shrink", 4, 3, 3)
    assert ev.restored_from_checkpoint and tr.restores == 1 and tr.restarts == 1
    # the checkpoint of step 2: steps 2 and 3 ran again, at dp 3
    assert state["step"] == 6 and len(losses) == 7 and tr.step == 6


# ---------------------------------------------------------------------------
# (e) the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "6", "--seq", "16", "--dp", "3",
       "--device", "cpu", "--schedule", "const"]


@pytest.mark.parametrize("mode", ["compressed", "local_sgd"])
def test_cli_elastic_policy_without_events_is_the_plain_loop(mode, capsys):
    plain = train_cli.main(CLI + ["--grad-sync", mode])
    el = train_cli.main(CLI + ["--grad-sync", mode, "--elastic-policy", "grow_on_join"])
    assert el["losses"] == plain["losses"] and not el["resizes"] and el["restores"] == 0
    for part in ("params", "opt"):
        assert_params_bit_identical(el["state"][part], plain["state"][part], part)
    assert "done (0 resizes, 0 checkpoint restores). final loss:" in capsys.readouterr().out


def test_cli_refuses_an_unknown_policy_and_tp(tmp_path):
    """An unknown policy is refused; ``--tp`` 2 runs in a world (here 4
    gloo processes at ``--dp 2 --tp 2``, ``gspmd`` with a checkpoint) and
    outside one is refused as the plain loop refuses it."""
    with pytest.raises(ValueError, match="unknown elastic policy 'nope'"):
        train_cli.main(CLI + ["--elastic-policy", "nope"])
    with pytest.raises(SystemExit, match="--tp 2 needs a world of at least"):
        train_cli.main(CLI + ["--elastic-policy", "grow_on_join", "--tp", "2"])
    argv = ["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "4", "--seq", "8", "--dp",
            "2", "--tp", "2", "--device", "cpu", "--schedule", "const", "--remat", "none",
            "--elastic-policy", "grow_on_join", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "1"]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "4", "-m", "repro_torch.launch.train"] + argv,
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "elastic (grow_on_join, dp=2 x tp=2 of a world of 4" in proc.stdout
    assert "done (0 resizes, 0 checkpoint restores)" in proc.stdout
    assert json.loads(open(tmp_path / "ck" / "step_2" / "manifest.json").read())["extra"][
        "tp"] == 2


# ---------------------------------------------------------------------------
# (f) the live-plan registry, recover, handle_failure, parse_chaos
# ---------------------------------------------------------------------------


def test_invalidate_drops_a_plans_memo_and_it_derives_again():
    plan = plans.CollectivePlan(p=3)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    want = plan.run(x)
    assert plan.__dict__["_memo_cache"]
    plan.invalidate()
    assert "_memo_cache" not in plan.__dict__
    assert torch.equal(plan.run(x), want) and plan.__dict__["_memo_cache"]


def test_live_plans_track_without_pinning_and_invalidate_all_reaches_each():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    a, b = plans.CollectivePlan(p=3), plans.CollectivePlan(p=3)  # equal, both tracked
    a.run(x), b.run(x)
    live = plans.live_plans()
    assert any(q is a for q in live) and any(q is b for q in live)
    assert plans.invalidate_all_plans() >= 2
    assert "_memo_cache" not in a.__dict__ and "_memo_cache" not in b.__dict__
    ref = weakref.ref(b)
    del b, live
    gc.collect()
    assert ref() is None  # the registry does not keep it alive
    assert not any(q is None for q in plans.live_plans())
    assert all(r() is not None for r in plans._LIVE_PLANS)  # the dead reference pruned


def test_the_live_plan_registry_prunes_dead_refs_amortized():
    plans.live_plans()
    n_live = len(plans._LIVE_PLANS)
    n = 4 * max(plans._PRUNE_THRESHOLD, 256)
    for _ in range(n):  # plans built and dropped, no resize ever
        plans.CollectivePlan(p=2)
    assert len(plans._LIVE_PLANS) <= plans._PRUNE_THRESHOLD <= max(256, 2 * n_live + 2)
    assert len(plans._LIVE_PLANS) < n


def test_recover_restores_the_latest_checkpoint_at_another_extent(tmp_path):
    cfg = registry.get_smoke_config(ARCH)
    tcfg = make_tcfg(bucket_bytes=1 << 14)
    ck = Checkpointer(str(tmp_path / "ck"))
    tr = _trainer(4, tcfg, ck)
    state, _ = tr.run(tr.init_or_restore(torch.Generator().manual_seed(0)), 3)
    ck.wait()
    fresh = step_lib.make_train_step(cfg, tcfg, dp=3, device="cpu").init_state(
        torch.Generator().manual_seed(4))
    template = {"params": convert.reference_tree(fresh["params"]),
                "step": torch.zeros((), dtype=torch.int32)}
    got, report = recover(Checkpointer(str(tmp_path / "ck")), template, "cpu",
                          old_dp=4, new_dp=3)
    assert (report.old_dp, report.new_dp, report.restored_step) == (4, 3, 3)
    assert report.elapsed_s >= 0 and int(got["step"]) == 3
    assert_params_bit_identical(convert.port_tree(got["params"]), state["params"], "recovered")
    with pytest.raises(RuntimeError, match="no checkpoint to recover from"):
        recover(Checkpointer(str(tmp_path / "empty")), template, old_dp=4, new_dp=3)


def test_handle_failure_shrinks_at_once_by_the_hook():
    cfg = registry.get_smoke_config(ARCH)
    tcfg = make_tcfg(bucket_bytes=1 << 14)
    tr = _trainer(4, tcfg)
    state, _ = tr.run(tr.init_or_restore(torch.Generator().manual_seed(0)), 2)
    before = copy.deepcopy(state)
    state = tr.handle_failure(state, {2})
    ev = tr.resizes[-1]
    assert (ev.kind, ev.old_dp, ev.new_dp, ev.step, ev.reason) == (
        "shrink", 4, 3, 2, "handle_failure")
    assert ev.keep == (0, 1, 3) and tr.device_ids() == (0, 1, 3) and tr.health[2] == "dead"
    assert tr.restores == 0 and not ev.restored_from_checkpoint
    want = gradsync.migrate_state(cfg, tcfg, (0, 1, 2, 3), (0, 1, 3), before, ev.keep)
    assert_params_bit_identical(state, want, "handle_failure")
    state, losses = tr.run(state, 1)  # trains on at dp 3, no second resize
    assert len(tr.resizes) == 1 and len(losses) == 1 and state["step"] == 3


def test_parse_chaos_reads_the_cli_specs():
    lines, calls = [], []

    class Target:
        def __getattr__(self, name):
            return lambda *a, **kw: calls.append((name, a, kw))

    script = parse_chaos(kill=["2:2", "7:1:silent"], join=["4:2,4"], stall=["3:1"],
                         unstall=["5:1"], log=lines.append)
    assert script.events == [Kill(2, 2), Stall(3, 1, 10.0), Join(4, (2, 4)), Unstall(5, 1),
                             Kill(7, 1, silent=True)]
    script.apply_due(Target(), 4)
    assert lines == ["# chaos @tick 4: kill(2,)", "# chaos @tick 4: stall(1, 10.0)",
                     "# chaos @tick 4: join((2, 4),)"]
    assert calls == [("kill", (2,), {"silent": False}), ("stall", (1, 10.0), {}),
                     ("join", ((2, 4),), {})]
    script.apply(Target(), 7)
    assert calls[-1] == ("kill", (1,), {"silent": True}) and len(script.fired) == 4
    assert parse_chaos(kill=["2:2"], join=["4:2,4"]).events == kill_join_script().events[:2]
    assert parse_chaos() is None


# ---------------------------------------------------------------------------
# (c) the reference's ElasticTrainer, recorded once
# ---------------------------------------------------------------------------

RECORD = """
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false")
sys.path.insert(0, {here!r})
import jax, numpy as np
from repro import compat
from repro.configs import registry
from repro.data.pipeline import DataConfig, SyntheticPipeline
from repro.distributed import gradsync
from repro.distributed import step as step_lib
from repro.optim.optimizer import OptimizerConfig
from repro.runtime import ElasticConfig, ElasticTrainer
from chaos import ChaosScript, Join, Kill

out = {{}}

def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[prefix + key] = np.asarray(jax.device_get(leaf))

real_migrate = gradsync.migrate_state
resizes = []

def migrate(cfg, tcfg, old_mesh, new_mesh, state, keep):
    j = len(resizes)
    resizes.append(j)
    save(f"resize{{j}}/pre/", state)
    new = real_migrate(cfg, tcfg, old_mesh, new_mesh, state, keep)
    save(f"resize{{j}}/post/", new)
    return new

gradsync.migrate_state = migrate
real_build = ElasticTrainer._build

def build(self):
    real_build(self)
    jit = self._jit

    def step(state, batch):
        i = int(state["step"])
        save(f"step{{i}}/pre/", state)
        save(f"step{{i}}/batch/", batch)
        new, m = jit(state, batch)
        save(f"step{{i}}/metrics/", m)
        return new, m

    self._jit = step

ElasticTrainer._build = build
cfg = registry.get_smoke_config({arch!r})
tcfg = step_lib.TrainConfig(
    microbatches=1, remat="none", grad_sync="mrd_zero1", monitor=True, monitor_mode="interval",
    monitor_threshold=1e-6, bucket_bytes={bucket_bytes},
    optimizer=OptimizerConfig(lr=5e-3, schedule="const", warmup_steps=0))
dcfg = DataConfig(batch=60, seq_len=8, seed=0)
mesh = compat.make_mesh((4,), ("data",), devices=jax.devices()[:4],
                        axis_types=compat.default_axis_types(1))
tr = ElasticTrainer(mesh, (cfg, tcfg), pipe_factory=lambda m: SyntheticPipeline(cfg, dcfg, m),
                    checkpointer=None, cfg=ElasticConfig(policy="grow_on_join"))
state = tr.init_or_restore(jax.random.PRNGKey(0))
state, losses = tr.run(state, 10, events=ChaosScript([Kill(2, 2), Join(4, (2, 4)), Kill(7, 1)]))
out["losses"] = np.asarray(losses, np.float64)
out["events"] = np.asarray(json.dumps([
    [e.kind, e.step, e.old_dp, e.new_dp, list(e.keep), list(e.device_ids),
     e.restored_from_checkpoint] for e in tr.resizes]))
np.savez(sys.argv[1], **out)
"""
RECORD_BUCKET_BYTES = 1 << 16  # several buckets


@pytest.fixture(scope="module", autouse=True)
def _recording(tmp_path_factory):
    """Start the reference's recording when the module starts: it runs in
    its own process while the tests before (c) run."""
    root = tmp_path_factory.mktemp("ref_elastic")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    script = RECORD.format(here=HERE, arch=ARCH, bucket_bytes=RECORD_BUCKET_BYTES)
    with open(root / "log.txt", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", script, str(root / "ref.npz")],
                                stdout=log, stderr=subprocess.STDOUT, env=env)
    yield proc, root
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference_elastic(_recording):
    proc, root = _recording
    rc = proc.wait(timeout=600)
    assert rc == 0, (root / "log.txt").read_text()[-6000:]
    z = np.load(root / "ref.npz")
    return {k: z[k] for k in z.files}


class _Replay:
    """A pipeline of the reference's recorded global batches (its state is
    the step, as the synthetic pipeline's)."""

    def __init__(self, z):
        self.z, self.step = z, 0

    def next_batch(self):
        b = tree(self.z, f"step{self.step}/batch/")
        self.step += 1
        return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}

    def state_dict(self):
        return {"step": self.step, "seed": 0}

    def load_state_dict(self, st):
        self.step = st["step"]


def _rtcfg():
    return make_tcfg(bucket_bytes=RECORD_BUCKET_BYTES)


def test_recorded_reference_resize_events(reference_elastic):
    z = reference_elastic
    cfg = registry.get_smoke_config(ARCH)
    want = json.loads(str(z["events"]))
    tr = ElasticTrainer((0, 1, 2, 3), (cfg, _rtcfg()), lambda m: _Replay(z),
                        cfg=ElasticConfig(policy="grow_on_join"), device="cpu")
    tr.init_or_restore(torch.Generator().manual_seed(0))
    state = convert.train_state_from_reference(tree(z, "step0/pre/"), cfg, "cpu")
    state, losses = tr.run(state, 10, events=kill_join_script())
    got = [[e.kind, e.step, e.old_dp, e.new_dp, list(e.keep), list(e.device_ids),
            e.restored_from_checkpoint] for e in tr.resizes]
    assert got == want
    # the losses, free-running from the reference's initial state on its
    # batches; a segment that drifts past the tolerance is held
    # teacher-forced, each step from the reference's state before it
    ref_losses = z["losses"].tolist()
    bounds = [0] + [e.step for e in tr.resizes] + [10]
    extents = [4] + [e.new_dp for e in tr.resizes]
    for a, b, dp in zip(bounds[:-1], bounds[1:], extents):
        if all(abs(losses[i] - ref_losses[i]) <= LOSS_ATOL for i in range(a, b)):
            continue
        step = step_lib.make_train_step(cfg, _rtcfg(), dp=dp, device="cpu")
        for i in range(a, b):
            before = convert.train_state_from_reference(tree(z, f"step{i}/pre/"), cfg, "cpu")
            _, m = step(before, _batch(z, i))
            assert abs(float(m["loss"]) - ref_losses[i]) <= LOSS_ATOL, (i, float(m["loss"]))


def _batch(z, i):
    b = tree(z, f"step{i}/batch/")
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def test_migrate_state_equals_the_recorded_references(reference_elastic):
    z = reference_elastic
    cfg = registry.get_smoke_config(ARCH)
    events = json.loads(str(z["events"]))
    ids = (0, 1, 2, 3)
    for j, (kind, step, old_dp, new_dp, keep, device_ids, _) in enumerate(events):
        pre = convert.train_state_from_reference(tree(z, f"resize{j}/pre/"), cfg, "cpu")
        got = gradsync.migrate_state(cfg, _rtcfg(), ids, tuple(device_ids), pre, tuple(keep))
        ids = tuple(device_ids)
        got = flat(jax_free(convert.train_state_to_reference(got)))
        want = tree(z, f"resize{j}/post/")
        want = {k: v for k, v in flat(want).items()}
        assert sorted(got) == sorted(want), j
        for k, v in want.items():
            assert np.array_equal(got[k], v.astype(got[k].dtype)), (j, k)
