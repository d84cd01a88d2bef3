"""The elastic trainer on a ``("data", "model")`` mesh at ``tp`` 2, in a
gloo world of 6 processes, against the reference's ``ElasticTrainer`` on
the same mesh; and fault f of the serving runtime.

One subprocess (started when the module starts) records the reference's
``ElasticTrainer`` on 8 forced host devices: the smoke ``llama3.2-1b``
under ``gspmd`` and ``mrd_zero1``, starting at ``(2, 2)`` over devices
``[[0, 1], [2, 3]]``, under the script ``Join(1, (4, 5))`` (to ``(3,
2)``, not a power of two), ``Kill(3, 1)`` (device 1's slice 0 dropped,
back to ``(2, 2)``) and ``Join(5, (0, 1))`` (to ``(3, 2)`` again, the
joiners last although their global ranks are the lowest: the mesh
``[[2, 3], [4, 5], [0, 1]]`` whose process groups number their ranks
otherwise than their coordinates).  Test-side wrappers record the state
before and after each ``migrate_state`` and before each step.

One gloo world of 6 processes replays it with the port's trainer, from
the reference's initial state on its batches (each ``"data"`` rank its
shard), every process running the same controller on the same script,
saving a checkpoint at the end of each one-step run (so at every extent).
The gates:

- every resize event equals the reference's exactly: kind, step,
  extents, keep map, device ids, reason;
- each step's loss from the reference's state before it (teacher-forced)
  is within 1e-5 of the reference's (``tests/test_torch_train_modes.py``'s
  tolerance); the free-running losses are reported;
- each resize hook, fed every coordinate's part of the reference's
  state before it (``rank_state``), gives every coordinate's part of the
  reference's state after it bit for bit (``gspmd``: the params, the
  master/moment trees and the monitor; ``mrd_zero1``: the master/moment
  rows of every segment owner over its local layout, the monitor);
- in the trainer's own run a ``gspmd`` world's global leaves after each
  resize equal those before it bit for bit (the FSDP blocks re-sharded
  over the new ``"data"`` extent), and after each grow every joiner's TP
  blocks of the params equal its column's source's (``mrd_zero1``);
- the last grow, whose joiners have the lowest global ranks, is held by
  the same gates as the others; and on its mesh (and on one reversed over
  ``"model"`` too), where a process group numbers its ranks otherwise
  than their coordinates, the sharding collectives (``gather_global``,
  the FSDP all-gather and its reduce-scatter, the data ranks' all-to-all,
  the model ranks' all-gather) place every rank's part at its
  coordinate (at ``dp`` 3 the smoke config shards no leaf over
  ``"data"``, so the steps alone would not show it);
- the checkpoint of step 8 at ``(3, 2)``, recovered into a fresh trainer
  at ``(3, 2)`` (the whole state) and at ``(2, 2)`` (the params), gives
  back the params, the step and the data cursor;
- the world is left through ``launch.train.end_world``, whose order of
  shutting the process groups down agrees between every two processes.

Fault f: a fixed-point serving script whose extent does not divide
``--n`` is refused before the first tick, and a resize the workload
cannot take is declined by the controller, which keeps the extent.
"""

import datetime
import json
import multiprocessing
import os
import subprocess
import sys
import traceback
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
ARCH = "llama3.2-1b"
MODES = ("gspmd", "mrd_zero1")
WORLD = 6
STEPS = 8
BATCH, SEQ = 12, 8
BUCKET_BYTES = 1 << 16  # several buckets
LOSS_ATOL = 1e-5  # tests/test_torch_train_modes.py's (test_torch_train_families.check_metrics)
SCRIPT = "[Join(1, (4, 5)), Kill(3, 1), Join(5, (0, 1))]"
# the meshes the script passes through, as the reference's device grids
GRIDS = ([[0, 1], [2, 3]], [[0, 1], [2, 3], [4, 5]], [[2, 3], [4, 5]],
         [[2, 3], [4, 5], [0, 1]])

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
tag = [""]

def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[tag[0] + prefix + key] = np.asarray(jax.device_get(leaf))

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
dcfg = DataConfig(batch={batch}, seq_len={seq}, seed=0)
for mode in {modes!r}:
    tag[0] = mode + "/"
    resizes.clear()
    tcfg = step_lib.TrainConfig(
        microbatches=1, remat="none", grad_sync=mode, monitor=True, monitor_mode="interval",
        monitor_threshold=1e-6, bucket_bytes={bucket_bytes},
        optimizer=OptimizerConfig(lr=5e-3, schedule="const", warmup_steps=0))
    mesh = compat.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                            axis_types=compat.default_axis_types(2))
    tr = ElasticTrainer(mesh, (cfg, tcfg), pipe_factory=lambda m: SyntheticPipeline(cfg, dcfg, m),
                        checkpointer=None, cfg=ElasticConfig(policy="grow_on_join"))
    state = tr.init_or_restore(jax.random.PRNGKey(0))
    state, losses = tr.run(state, {steps}, events=ChaosScript({script}))
    out[mode + "/losses"] = np.asarray(losses, np.float64)
    out[mode + "/events"] = np.asarray(json.dumps([
        [e.kind, e.step, e.old_dp, e.new_dp, list(e.keep), list(e.device_ids), e.reason,
         e.restored_from_checkpoint] for e in tr.resizes]))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _recording(tmp_path_factory):
    """Start the reference's recording when the module starts: it runs in
    its own process while the fault f tests run."""
    root = tmp_path_factory.mktemp("ref_elastic_tp")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    script = RECORD.format(here=str(HERE), arch=ARCH, batch=BATCH, seq=SEQ, modes=MODES,
                           bucket_bytes=BUCKET_BYTES, steps=STEPS, script=SCRIPT)
    with open(root / "log.txt", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", script, str(root / "ref.npz")],
                                stdout=log, stderr=subprocess.STDOUT, env=env)
    yield proc, root
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# ---------------------------------------------------------------------------
# Fault f: fixed-point extents that do not divide n
# ---------------------------------------------------------------------------

FP_CHAOS = ["--kill", "6:2", "--stall", "10:1:10", "--join", "16:4,5", "--unstall", "22:1",
            "--kill", "26:0"]


def test_a_fixedpoint_script_whose_extent_does_not_divide_n_is_refused_at_the_start():
    from repro_torch.launch import serve as cli
    from repro_torch.serving import ServeEngine

    argv = ["--continuous", "--workload", "fixedpoint_solve", "--solver", "d_iteration",
            "--n", "64", "--dp", "4", "--requests", "4", "--device", "cpu",
            "--elastic-policy", "grow_on_join", "--steps-per-dispatch", "4"] + FP_CHAOS
    with mock.patch.object(ServeEngine, "step", side_effect=AssertionError("a tick ran")):
        with pytest.raises(SystemExit, match="kill at tick 6 leaves 3 replicas"):
            cli.main(argv)


def test_a_resize_the_workload_cannot_take_is_declined_and_the_extent_kept():
    import torch_chaos as tc
    from repro_torch import runtime as rt
    from repro_torch.serving import Request, ServeConfig, ServeEngine, make_workload

    wl = make_workload("fixedpoint_solve", solver="d_iteration", n=64, dp=4, slots=3,
                       damping=0.7, seed=1, device="cpu")
    eng = ServeEngine(wl, ServeConfig(termination="residual_interval", dp=4, eps=1e-6,
                                      steps_per_dispatch=3))
    lines: list = []
    ctl = rt.ElasticServeController(eng, policy="grow_on_join", log=lines.append)
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(4):
        v = rng.random(64).astype(np.float32)
        reqs.append(Request(id=i, arrival=2 * i, payload=v / v.sum(), max_new=800))
    res = ctl.run(reqs, events=tc.script())
    # 4 -> 3 and 5 -> 4 -> ... : only extents that split n = 64 are taken
    assert all(64 % e.new_dp == 0 for e in ctl.resizes)
    assert {d[1:3] for d in ctl.declined} >= {("shrink", 3)}
    assert eng.dp == wl.pool.dp and 64 % eng.dp == 0
    assert lines and all("resize declined" in ln and "n=64 must divide" in ln for ln in lines)
    assert len(lines) < len(ctl.declined)  # logged once until the reason changes
    assert sorted(res) == list(range(4)) and all(r.converged for r in res.values())


def test_every_extent_that_divides_n_is_taken():
    """The same script at n = 60 (every extent it reaches divides it): no
    decline, the reference suite's trajectory."""
    import torch_chaos as tc
    from repro_torch import runtime as rt
    from repro_torch.runtime.chaos import scripted_extents
    from repro_torch.serving import Request, ServeConfig, ServeEngine, make_workload

    assert [e for _, e in scripted_extents(tc.script(), range(4))] == [3, 5, 4]
    wl = make_workload("fixedpoint_solve", solver="d_iteration", n=60, dp=4, slots=3,
                       damping=0.7, seed=1, device="cpu")
    eng = ServeEngine(wl, ServeConfig(termination="residual_interval", dp=4, eps=1e-6,
                                      steps_per_dispatch=3))
    ctl = rt.ElasticServeController(eng, policy="grow_on_join", log=pytest.fail)
    rng = np.random.default_rng(7)
    reqs = [Request(id=i, arrival=2 * i, payload=(v := rng.random(60).astype(np.float32))
                    / v.sum(), max_new=800) for i in range(4)]
    ctl.run(reqs, events=tc.script())
    assert tc.trajectory(ctl.resizes) == tc.TRAJECTORY and not ctl.declined


# ---------------------------------------------------------------------------
# The world of 6 against the reference's ElasticTrainer
# ---------------------------------------------------------------------------


def _tree(z, prefix: str) -> dict:
    out: dict = {}
    for k, v in z.items():
        if k.startswith(prefix):
            parts = k[len(prefix):].split("/")
            node = out
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
    return out


def _tcfg(mode):
    from repro_torch.distributed import step as step_lib
    from repro_torch.optim.optimizer import OptimizerConfig

    return step_lib.TrainConfig(
        microbatches=1, remat="none", grad_sync=mode, monitor=True, monitor_mode="interval",
        monitor_threshold=1e-6, bucket_bytes=BUCKET_BYTES,
        optimizer=OptimizerConfig(lr=5e-3, schedule="const", warmup_steps=0))


class _Replay:
    """The reference's recorded global batches, ``"data"`` rank ``rank``'s
    shard of each (its state is the step, as the synthetic pipeline's)."""

    def __init__(self, z, mode, rank, dp):
        self.z, self.mode, self.rank, self.dp, self.step = z, mode, rank, dp, 0

    def batch(self, i):
        b = _tree(self.z, f"{self.mode}/step{i}/batch/")
        per = BATCH // self.dp
        return {k: torch.from_numpy(v[self.rank * per:(self.rank + 1) * per].astype(np.int64))
                for k, v in b.items()}

    def next_batch(self):
        self.step += 1
        return self.batch(self.step - 1)

    def state_dict(self):
        return {"step": self.step, "seed": 0}

    def load_state_dict(self, st):
        self.step = st["step"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _same(a, b, skip=()) -> list:
    """Key paths where two states differ (tensors by ``torch.equal``, host
    values by ``==``)."""
    fa, fb = _flat(a), _flat(b)
    bad = sorted(set(fa) ^ set(fb))
    for k in set(fa) & set(fb):
        if any(k.startswith(s) for s in skip):
            continue
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            x, y = torch.as_tensor(x), torch.as_tensor(y)
            if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _digest(tree) -> list:
    return [(k, float(v.double().sum()), float(v.double().abs().sum()))
            for k, v in sorted(_flat(tree).items())]


def _mode_run(mode, z, rank, ck_dir):
    """One mode's replay on this process of the world: the trainer's run,
    the teacher-forced losses, the hooks against the recorded resizes, the
    checkpoint recoveries.  Returns this process's record."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import registry
    from repro_torch.distributed import gradsync
    from repro_torch.distributed import step as step_lib
    from repro_torch.distributed.gradsync import common
    from repro_torch.distributed.gradsync.mrd_zero1 import zero1_owner_segments
    from repro_torch.models import convert
    from repro_torch.runtime import ElasticConfig, ElasticTrainer
    from repro_torch.runtime.chaos import ChaosScript, Join, Kill

    cfg, tcfg = registry.get_smoke_config(ARCH), _tcfg(mode)
    meshes = [DeviceMesh("cpu", torch.tensor(g), mesh_dim_names=("data", "model"))
              for g in GRIDS]

    def ref_state(prefix):
        return convert.train_state_from_reference(_tree(z, f"{mode}/{prefix}"), cfg, "cpu")

    def pipe(m):
        return _Replay(z, mode, common.mesh_rank(m), common.mesh_dp(m))

    rec = {"losses": [], "forced": {}, "resizes": [], "hooks": []}
    ck = Checkpointer(str(ck_dir), world=(rank, WORLD))
    tr = ElasticTrainer(meshes[0], (cfg, tcfg), pipe, checkpointer=ck,
                        cfg=ElasticConfig(policy="grow_on_join", ckpt_every=100), device="cpu")
    tr.init_or_restore(torch.Generator().manual_seed(0))
    state = tr.train_step.rank_state(ref_state("step0/pre/")) if tr.member() else None

    real_resize = ElasticTrainer.resize

    def resize(self, st, decision):
        entry = {}
        if self.member() and mode == "gspmd":  # a copy: the steps update the optimizer in place
            entry["pre"] = _clone(self.train_step.global_state(st))
        out = real_resize(self, st, decision)
        if self.member():
            coord = tuple(int(c) for c in self.mesh.get_coordinate())
            entry["coord"] = coord
            entry["params"] = _digest(out["params"])
            if mode == "gspmd":
                entry["post"] = _clone(self.train_step.global_state(out))
        rec["resizes"].append(entry)
        return out

    script = eval(SCRIPT, {"Join": Join, "Kill": Kill})
    events = ChaosScript(script)
    with mock.patch.object(ElasticTrainer, "resize", resize):
        for _ in range(STEPS):
            state, got = tr.run(state, 1, events=events)
            rec["losses"] += got
            i = tr.step - 1
            if tr.member():  # the step again, from the reference's state before it
                _, m = tr.train_step(tr.train_step.rank_state(ref_state(f"step{i}/pre/")),
                                     tr.pipe.batch(i))
                rec["forced"][i] = float(m["loss"])
    rec["events"] = [[e.kind, e.step, e.old_dp, e.new_dp, list(e.keep), list(e.device_ids),
                      e.reason, e.restored_from_checkpoint] for e in tr.resizes]

    # each hook fed the reference's state before the resize
    for j, ev in enumerate(json.loads(str(z[f"{mode}/events"]))):
        keep = tuple(ev[4])
        old, new = meshes[j], meshes[j + 1]
        in_old = common.mesh_rank(old) is not None
        d_n = common.mesh_rank(new)
        if not in_old and d_n is None:
            rec["hooks"].append(None)
            continue
        new_step = None if d_n is None else step_lib.make_train_step(
            cfg, tcfg, dp=ev[3], device="cpu", mesh=new)
        if d_n is not None and keep[d_n] is None:
            pre = new_step.init_state(torch.Generator().manual_seed(3))
        else:
            old_step = step_lib.make_train_step(cfg, tcfg, dp=ev[2], device="cpu", mesh=old)
            pre = old_step.rank_state(ref_state(f"resize{j}/pre/"))
        got = gradsync.migrate_state(cfg, tcfg, old, new, pre, keep)
        if d_n is None:
            rec["hooks"].append(None)
            continue
        want = new_step.rank_state(ref_state(f"resize{j}/post/"))
        # a joiner's step comes by the trainer's broadcast
        skip = ["/step"] if keep[d_n] is None else []
        if mode != "gspmd":
            # the joiners' params come by the trainer's broadcast; a ZeRO-1
            # rank that owns no segment holds no master/moment row
            skip.append("/params")
            if zero1_owner_segments(ev[3])[d_n] is None:
                skip += ["/opt/master", "/opt/mu", "/opt/nu"]
        rec["hooks"].append(_same(got, want, skip=skip))

    # the checkpoint of the last step, recovered at (3, 2) and at (2, 2)
    ck.wait()
    final = state
    if mode == "gspmd" and tr.member():
        rec["final_global"] = tr.train_step.global_state(state)
    for name, mesh in (("same", meshes[3]), ("other", meshes[0])):
        tr2 = ElasticTrainer(mesh, (cfg, tcfg), pipe,
                             checkpointer=Checkpointer(str(ck_dir), world=(rank, WORLD)),
                             cfg=ElasticConfig(policy="grow_on_join"), device="cpu")
        st = tr2.init_or_restore(torch.Generator().manual_seed(5))
        if st is None:
            continue
        got = {"step": st["step"], "trainer_step": tr2.step, "cursor": tr2.pipe.step}
        if mode == "gspmd":
            got["global"] = tr2.train_step.global_state(st)
        else:
            got["params"] = _same(st["params"], final["params"])
            if name == "same":
                got["opt"] = _same(st["opt"], final["opt"])
        rec[name] = got
    return rec


# meshes whose process groups number their ranks otherwise than their
# coordinates: the last grow's (over "data"), and one reversed over "model"
# too
SHUFFLED = ([[2, 3], [4, 5], [0, 1]], [[3, 2], [5, 4], [1, 0]])


def _axis_checks(mesh) -> list:
    """The sharding collectives on ``mesh``, each rank's part placed by its
    coordinate: ``gather_global`` of ``("data", "model")`` blocks, the
    FSDP all-gather and its reduce-scatter backward, the data ranks'
    all-to-all and the model ranks' all-gather.  Returns the names of those
    that differ from the arithmetic (exact in fp32 at these sizes)."""
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as shd

    cfg = registry.get_smoke_config(ARCH)
    coords = shd.mesh_coords(mesh)
    sizes = {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    dp, tp = sizes["data"], sizes["model"]
    whole = torch.arange(dp * 2 * tp * 3, dtype=torch.float32).reshape(dp * 2, tp * 3)
    block = shd.local_shard(whole, ("data", "model"), coords, sizes).clone()
    bad = []
    if not torch.equal(shd.gather_global(block, ("data", "model"), mesh), whole):
        bad.append("gather_global")
    with shd.sharding_ctx(cfg, shd.make_rules(cfg, mesh), mesh):
        x = block.clone().requires_grad_()
        y = shd.gather_fsdp(x, ("data", None))
        want = shd.local_shard(whole, (None, "model"), coords, sizes)
        if not torch.equal(y.detach(), want):
            bad.append("gather_fsdp")
        (y * want).sum().backward()
        if not torch.equal(x.grad, dp * block):
            bad.append("gather_fsdp backward")
        mine = float(coords["data"])
        sent = mine + 10 * torch.arange(dp, dtype=torch.float32)[:, None].expand(dp, 2)
        got = shd.data_all_to_all(sent, 0, 0)  # row r: what data rank r sent this one
        if not torch.equal(got, torch.arange(dp, dtype=torch.float32)[:, None].expand(dp, 2)
                           + 10 * mine):
            bad.append("data_all_to_all")
        g = shd.tp_gather(torch.tensor([[float(coords["model"])]]), 1)
        if not torch.equal(g, torch.arange(tp, dtype=torch.float32)[None]):
            bad.append("tp_gather")
    return bad


def _world_rank(rank, store, out_dir, ref_path):
    import torch.distributed as dist

    from repro_torch.launch import train as train_cli

    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=WORLD, timeout=datetime.timedelta(seconds=90))
        try:
            z = dict(np.load(ref_path))
            from torch.distributed.device_mesh import DeviceMesh

            out = {mode: _mode_run(mode, z, rank, out_dir / f"ck_{mode}") for mode in MODES}
            out["axes"] = [_axis_checks(DeviceMesh("cpu", torch.tensor(g),
                                                   mesh_dim_names=("data", "model")))
                           for g in SHUFFLED]
            out["teardown"] = [tuple(sorted(dist.get_process_group_ranks(pg)))
                               for pg in train_cli.teardown_order()]
            torch.save(out, out_dir / f"rank{rank}.pt")
        finally:
            train_cli.end_world()
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def reference(_recording):
    proc, root = _recording
    rc = proc.wait(timeout=600)
    assert rc == 0, (root / "log.txt").read_text()[-6000:]
    return root / "ref.npz"


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_tp_world")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_world_rank,
                         args=(r, str(root / "store"), str(root), str(reference)), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    errs = {r: (root / f"rank{r}.err").read_text() for r in range(WORLD)
            if (root / f"rank{r}.err").exists()}
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not errs and all(p.exitcode == 0 for p in procs), errs
    z = dict(np.load(reference))
    return z, [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


# the steps each process sits out: 4 and 5 until they join, 0 and 1 after
# device 1's kill until they join again
SAT_OUT = {0: {3, 4}, 1: {3, 4}, 4: {0}, 5: {0}}


@pytest.mark.parametrize("mode", MODES)
def test_resize_events_equal_the_references(world, mode):
    z, ranks = world
    want = json.loads(str(z[f"{mode}/events"]))
    assert [ev[6] for ev in want] == ["join: [4, 5]", "heartbeat failure: [1]", "join: [0, 1]"]
    for r, out in enumerate(ranks):
        assert out[mode]["events"] == want, r


@pytest.mark.parametrize("mode", MODES)
def test_teacher_forced_losses_match_the_references(world, mode):
    z, ranks = world
    ref = z[f"{mode}/losses"].tolist()
    for r, out in enumerate(ranks):
        rec = out[mode]
        assert {i for i, x in enumerate(rec["losses"]) if x is None} == SAT_OUT.get(r, set()), r
        assert sorted(rec["forced"]) == sorted(set(range(STEPS)) - SAT_OUT.get(r, set())), r
        for i, loss in rec["forced"].items():
            assert abs(loss - ref[i]) <= LOSS_ATOL, (mode, r, i, loss, ref[i])


@pytest.mark.parametrize("mode", MODES)
def test_each_hook_gives_the_references_state_after_the_resize(world, mode):
    _, ranks = world
    for j in range(3):
        members = [r for r, out in enumerate(ranks) if out[mode]["hooks"][j] is not None]
        assert len(members) == (6 if j != 1 else 4), (j, members)
        for r in members:
            assert ranks[r][mode]["hooks"][j] == [], (mode, j, r)


def test_gspmd_resizes_keep_the_global_leaves_bit_for_bit(world):
    """Every resize, the last grow over ranks out of order included: the
    old mesh's root gathered the global leaves before it, the new mesh's
    root after it (the FSDP blocks re-sharded over the new extent)."""
    _, ranks = world
    roots = [0, 0, 2]  # the old mesh's root and ...
    new_roots = [0, 2, 2]  # ... the new one's, by global rank
    for j in range(3):
        pre = ranks[roots[j]]["gspmd"]["resizes"][j]["pre"]
        post = ranks[new_roots[j]]["gspmd"]["resizes"][j]["post"]
        assert pre is not None and post is not None, j
        assert _same({"params": pre["params"], "opt": pre["opt"]},
                     {"params": post["params"], "opt": post["opt"]}) == [], j


def test_every_member_shuts_its_groups_down_in_one_order(world):
    """``launch.train.end_world``'s order (each group a process holds, the
    newest first, the default group last) agrees between every pair of
    processes: the groups two processes share come in the same order on
    both, so a shutdown that waits for a group's other members cannot
    wait in a cycle.  Sorted by name, as ``destroy_process_group()``
    takes them, they need not: on NCCL a group split off the default one
    is named after the count of groups its maker holds, and a rank
    outside a mesh holds none of its groups."""
    _, ranks = world
    for a in range(WORLD):
        assert ranks[a]["teardown"][-1] == tuple(range(WORLD)), a
        for b in range(a + 1, WORLD):
            shared_a = [g for g in ranks[a]["teardown"] if b in g]
            shared_b = [g for g in ranks[b]["teardown"] if a in g]
            assert shared_a == shared_b, (a, b)
    # ranks 2 and 3 share a "model" group on every mesh of both modes
    assert len([g for g in ranks[2]["teardown"] if g == (2, 3)]) >= 6


def test_the_axis_collectives_place_each_rank_by_its_coordinate(world):
    """On the last grow's mesh (and one reversed over ``"model"`` too) a
    process group numbers its ranks otherwise than their coordinates; the
    sharding collectives place every rank's part at its coordinate."""
    _, ranks = world
    for r, out in enumerate(ranks):
        assert out["axes"] == [[], []], r


def test_zero1_joiners_hold_their_columns_source_blocks(world):
    """After each grow every joiner's TP blocks of the params equal those
    of data coordinate 0 of its model column."""
    _, ranks = world
    for j, joiners in ((0, (4, 5)), (2, (0, 1))):
        by_coord = {ranks[r]["mrd_zero1"]["resizes"][j]["coord"]: ranks[r]["mrd_zero1"]
                    ["resizes"][j]["params"] for r in range(WORLD)
                    if "coord" in ranks[r]["mrd_zero1"]["resizes"][j]}
        assert len(by_coord) == 6
        for r in joiners:
            d, m = ranks[r]["mrd_zero1"]["resizes"][j]["coord"]
            assert d == 2 and by_coord[(d, m)] == by_coord[(0, m)], (j, r)


@pytest.mark.parametrize("mode", MODES)
def test_a_checkpoint_recovers_at_the_same_and_another_extent(world, mode):
    _, ranks = world
    for name, members in (("same", range(WORLD)), ("other", range(4))):
        for r in members:
            got = ranks[r][mode].get(name)
            assert got is not None, (name, r)
            assert got["step"] == got["trainer_step"] == got["cursor"] == STEPS, (name, r, got)
            if mode != "gspmd":
                assert got["params"] == [], (name, r)
                assert got.get("opt", []) == [], (name, r)
    if mode == "gspmd":  # the global leaves, gathered on each mesh's root
        final = ranks[2][mode]["final_global"]
        same, other = ranks[2][mode]["same"]["global"], ranks[0][mode]["other"]["global"]
        assert _same({"params": same["params"], "opt": same["opt"]},
                     {"params": final["params"], "opt": final["opt"]}) == []
        assert _same(other["params"], final["params"]) == []
