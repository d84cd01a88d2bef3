"""Multi-process worlds for the port's device executors (gloo on the CPU).

:func:`run_world` spawns one process a rank, joins a ``gloo`` process
group through a file store under a directory the caller owns, builds a
:class:`~torch.distributed.device_mesh.DeviceMesh` and runs one scenario
of :data:`SCENARIOS` in every rank.  Each rank saves what it computed
(a dict of tensors) with ``torch.save``; :func:`run_world` returns the
ranks' dicts in rank order.

A world never hangs the suite: the process group has a short timeout, the
parent joins every rank under a deadline of its own, kills whatever is
still alive then, and raises :class:`WorldFailed` with each failed rank's
traceback.

The inputs are drawn from a seed with numpy in every rank, the whole
stacked ``[p, ...]`` array each time, and each rank keeps its own row, so
the parent can run the sim executor on exactly the stacked inputs.  This
module imports neither ``jax`` nor the reference package: the workers are
the port alone.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# one-axis worlds: n = 2 * 256 * p0 elements a rank (reduce-scatter halves
# it mu0 times; int8 needs whole 256-blocks)
OPS = ("sum", "max", "min")
EXECUTORS = ("device", "device_fused")
TRANSFORMS = ("identity", "int8")
TREE_SHAPES = {"a": (37,), "b": {"c": (5, 64), "d": (300,)}, "e": (2, 3, 17), "f": (1000,)}
TREE_BUCKET_BYTES = 2048  # several buckets of the tree above


class WorldFailed(RuntimeError):
    pass


def one_axis_length(p: int) -> int:
    p0 = 1 << (p.bit_length() - 1)
    return 2 * 256 * p0


def stacked_inputs(p: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((p, n)).astype(np.float32)


def stacked_tree(p: int, seed: int, shapes=TREE_SHAPES) -> dict:
    rng = np.random.default_rng(seed)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return torch.from_numpy(rng.standard_normal((p,) + node).astype(np.float32))

    return build(shapes)


def row(tree, r: int):
    if isinstance(tree, dict):
        return {k: row(v, r) for k, v in tree.items()}
    return tree[r].clone()


def to(tree, device):
    if isinstance(tree, dict):
        return {k: to(v, device) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return tree.to(device)


def flat(tree, prefix: str) -> dict:
    """A tree's leaves under ``prefix/path`` keys."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# Scenarios: (mesh, rank, **args) -> {name: tensor}
# ---------------------------------------------------------------------------


def one_axis(mesh, rank: int, device, *, p: int, seed: int) -> dict:
    """Every one-axis plan of the port over the mesh dimension ``r``, on
    the device and device_fused executors."""
    from repro_torch.collectives import plans

    n = one_axis_length(p)
    x = torch.from_numpy(stacked_inputs(p, n, seed)[rank]).to(device)
    tree = to(row(stacked_tree(p, seed + 1), rank), device)
    out = {}
    kw = dict(axes=("r",), mesh=mesh)
    for ex in EXECUTORS:
        for op in OPS:
            out[f"mrd_{op}_{ex}"] = plans.allreduce_plan(op=op, executor=ex, **kw).run(x)
        out[f"mrd_blocking_{ex}"] = plans.allreduce_plan(executor=ex, **kw).run_blocking(x)
        for tf in TRANSFORMS:
            out[f"mrd_{tf}_{ex}"] = plans.allreduce_plan(transform=tf, executor=ex, **kw).run(x)
            out[f"rabenseifner_{tf}_{ex}"] = plans.allreduce_plan(
                schedule="rabenseifner", transform=tf, executor=ex, **kw).run(x)
            red = plans.reduce_scatter_plan(transform=tf, executor=ex, **kw).run(x)
            out[f"rs_{tf}_{ex}"] = red
            out[f"rsag_{tf}_{ex}"] = plans.allgather_plan(executor=ex, **kw).run(red)
            for sched in ("mrd", "rabenseifner"):
                out.update(flat(plans.tree_allreduce(
                    tree, schedule=sched, transform=tf, executor=ex,
                    bucket_bytes=TREE_BUCKET_BYTES, **kw), f"tree_{sched}_{tf}_{ex}"))
        # late admission: bucket 1 enters two stages after bucket 0, bucket 2
        # after one more; drained stage-major
        plan = plans.allreduce_plan(schedule="rabenseifner", transform="int8", executor=ex, **kw)
        bufs = [x[: n // 2], x, x[n // 2:]]
        pipe = plan.pipeline()
        pipe.admit(0, bufs[0])
        pipe.advance()
        pipe.advance()
        pipe.admit(1, bufs[1])
        pipe.advance()
        pipe.admit(2, bufs[2])
        done = pipe.drain()
        for k, b in enumerate(plan.run_buffers(list(bufs))):
            out[f"pipeline_{k}_{ex}"] = done[k]
            out[f"run_buffers_{k}_{ex}"] = b
    out["int8_block128"] = plans.allreduce_plan(
        schedule="rabenseifner", transform="int8", block=128, executor="device_fused",
        **kw).run(x)
    return out


def two_axis(mesh, rank: int, device, *, seed: int, n: int) -> dict:
    """Chained plans over the ``(pod, data)`` mesh."""
    from repro_torch.collectives import plans

    world = mesh.size()
    x = torch.from_numpy(stacked_inputs(world, n, seed)[rank]).to(device)
    out = {}
    for ex in EXECUTORS:
        for tf in TRANSFORMS:
            for name, sched, axes in (("mrd", "mrd", ("pod", "data")),
                                      ("rabenseifner", "rabenseifner", ("pod", "data")),
                                      ("hierarchical", "hierarchical", ("data", "pod"))):
                plan = plans.allreduce_plan(schedule=sched, transform=tf, executor=ex,
                                            axes=axes, mesh=mesh)
                out[f"{name}_{tf}_{ex}"] = plan.run(x)
                if tf == "identity" and ex == "device":
                    out[f"table_{name}"] = [
                        (st.kind, st.pairs, st.distance, st.payload_fraction, coll, ai, p)
                        for st, coll, ai, p in plan.bound_stage_table()]
                    # a frozen plan holding a DeviceMesh stays hashable
                    twin = plans.allreduce_plan(schedule=sched, transform=tf, executor=ex,
                                                axes=axes, mesh=mesh)
                    out[f"hashable_{name}"] = torch.tensor(
                        twin == plan and hash(twin) == hash(plan) and len({twin, plan}) == 1)
    return out


def monitor(mesh, rank: int, device, *, steps: int) -> dict:
    """The exact-mode ConvergenceMonitor over ``(pod, data)``: rank r
    contributes (r + 1) * base[i] at step i; every permute is counted."""
    from repro_torch.asynchrony.protocols import ConvergenceMonitor
    from repro_torch.collectives import executors

    permutes = []
    orig = executors.DeviceBackend.permute

    def counted(self, x, pairs):
        permutes.append(x.numel())
        return orig(self, x, pairs)

    executors.DeviceBackend.permute = counted
    mon = ConvergenceMonitor(axis_name=("pod", "data"), mesh=mesh, threshold=1e-3, mode="exact")
    base = np.geomspace(1.0, 1e-6, steps).astype(np.float32)
    state = mon.init(device=device)
    dones, vals, per_step = [], [], []
    for i in range(steps):
        before = len(permutes)
        state, done, val = mon.step(state, torch.tensor((rank + 1) * base[i], device=device), i)
        dones.append(bool(done))
        vals.append(float(val))
        per_step.append(len(permutes) - before)
    return {"dones": torch.tensor(dones), "vals": torch.tensor(vals),
            "permutes": torch.tensor(per_step), "numel": torch.tensor(permutes),
            "cycle_length": torch.tensor(mon._plan().cycle_length())}


def mismatched(mesh, rank: int, device) -> dict:
    """A stage the two ranks disagree on: each waits for a message that
    the other never sends."""
    from repro_torch.collectives import executors

    be = executors.DeviceBackend("r", mesh)
    pairs = ((1 - rank, rank),)
    return {"x": executors.landed(be.permute(torch.ones(4, device=device), pairs))}


# ---------------------------------------------------------------------------
# The trainer's world: every grad-sync mode, one process a rank
# ---------------------------------------------------------------------------

TRAIN_ARCH = "llama3.2-1b"
TRAIN_SEQ = 16
TRAIN_LR = 1e-2


def train_tcfg(conf: dict):
    """The TrainConfig of one run of the train scenario: ``conf`` names
    the mode, the optimizer, the microbatches; the rest is fixed (small
    buckets so the smoke model spans several, the monitor on where the
    mode has one, ``local_sgd`` averaging every 2 steps)."""
    from repro_torch.distributed import step as step_lib
    from repro_torch.optim.optimizer import OptimizerConfig

    return step_lib.TrainConfig(
        microbatches=conf.get("microbatches", 2), remat=conf.get("remat", "none"),
        grad_sync=conf["mode"], monitor=conf["mode"] != "local_sgd", monitor_mode="inexact",
        monitor_threshold=6.0, local_sync_every=2, bucket_bytes=1 << 14,
        optimizer=OptimizerConfig(name=conf.get("optimizer", "adamw"), lr=TRAIN_LR,
                                  schedule="const", warmup_steps=0, grad_clip=1.0))


def conf_tag(conf: dict) -> str:
    return f"{conf['mode']}-{conf.get('optimizer', 'adamw')}"


class MonitorMessages:
    """Counts the messages the ConvergenceMonitor's plan sends while this
    is entered: on a world rank its own sends, on the sim every pair of a
    stage (one message each)."""

    def __init__(self):
        from repro_torch.asynchrony.protocols import ConvergenceMonitor
        from repro_torch.collectives import executors

        self.count, self.inside = 0, False
        counter = self
        dev_permute, sim_permute = executors.DeviceBackend.permute, executors.SimBackend.permute
        mon_step = ConvergenceMonitor.step

        def device_permute(be, x, pairs):
            if counter.inside:
                counter.count += len(executors._peers(be._rank, tuple(pairs))[0])
            return dev_permute(be, x, pairs)

        def stacked_permute(be, x, pairs):
            if counter.inside:
                counter.count += len(pairs)
            return sim_permute(be, x, pairs)

        def step(mon, *a, **k):
            counter.inside = True
            try:
                return mon_step(mon, *a, **k)
            finally:
                counter.inside = False

        executors.DeviceBackend.permute = device_permute
        executors.SimBackend.permute = stacked_permute
        ConvergenceMonitor.step = step

    def take(self) -> int:
        n, self.count = self.count, 0
        return n


def _record(out: dict, prefix: str, state, metrics, msgs: int, *, world: bool, replica: bool):
    from repro_torch.models import convert

    if world:
        tree, _ = convert.rank_state_to_reference(state, replica=replica)
    else:
        tree = convert.train_state_to_reference(state)
    out.update({k: v.detach().clone() for k, v in flat(tree, prefix + "/state").items()})
    for k in ("loss", "grad_norm", "converged", "monitor_value", "aux_loss"):
        if k in metrics:
            out[f"{prefix}/metrics/{k}"] = metrics[k].detach().clone()
    out[f"{prefix}/monitor_msgs"] = torch.tensor(msgs)


def train_world(mesh, rank: int, device, *, dp: int, configs: list, steps: int, batch: int,
                ckpt: dict = None) -> dict:
    """Train the smoke ``llama3.2-1b`` under every ``configs`` entry for
    ``steps`` steps as this rank of a world, from seed 0, recording after
    each step the rank's state (as the reference nests it), its metrics
    and the monitor's messages.  With ``ckpt`` ({tag: {"world": dir,
    "sim": dir}}) the run of ``tag`` also saves a world checkpoint after
    step 1, then resumes from it and, separately, from the sim's
    checkpoint of step 1 in ``sim``, and records the steps after."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import step as step_lib
    from repro_torch.models import convert

    cfg = registry.get_smoke_config(TRAIN_ARCH)
    msgs = MonitorMessages()
    pipe = SyntheticPipeline(cfg, DataConfig(batch=batch, seq_len=TRAIN_SEQ, seed=0), device,
                             rank=rank, dp=dp)
    batches = [pipe.next_batch() for _ in range(steps)]
    out = {}
    for conf in configs:
        tag = conf_tag(conf)
        replica = conf["mode"] == "local_sgd"
        step = step_lib.make_train_step(cfg, train_tcfg(conf), dp=dp, device=device, mesh=mesh)
        state = step.init_state(torch.Generator(device=device).manual_seed(0))
        msgs.take()
        for i in range(steps):
            state, m = step(state, batches[i])
            _record(out, f"{tag}/step{i + 1}", state, m, msgs.take(), world=True,
                    replica=replica)
            if ckpt and tag in ckpt and i == 0:
                ck = Checkpointer(ckpt[tag]["world"], world=(rank, dp))
                tree, rows = convert.rank_state_to_reference(state, replica=replica)
                ck.save(1, tree, extra={"dp": dp}, block=True, rows=rows)
        if not ckpt or tag not in ckpt:
            continue
        for name, where in (("resumed", ckpt[tag]["world"]), ("from_sim", ckpt[tag]["sim"])):
            ck = Checkpointer(where, world=(rank, dp))
            template, rows = convert.rank_state_to_reference(state, replica=replica)
            state = convert.rank_state_from_reference(
                ck.restore_rank(1, template, rows), cfg, device)
            for i in range(1, steps):
                state, m = step(state, batches[i])
                _record(out, f"{tag}/{name}/step{i + 1}", state, m, msgs.take(), world=True,
                        replica=replica)
    return out


def sim_train(dp: int, configs: list, steps: int, batch: int, device="cpu",
              save: dict = None) -> dict:
    """What the stacked-rows trainer gives on :func:`train_world`'s runs
    (the same keys, rows ``[dp, ...]``); with ``save`` ({tag: dir}) each
    such run saves its checkpoint after step 1 there."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import step as step_lib
    from repro_torch.models import convert

    cfg = registry.get_smoke_config(TRAIN_ARCH)
    msgs = MonitorMessages()
    pipe = SyntheticPipeline(cfg, DataConfig(batch=batch, seq_len=TRAIN_SEQ, seed=0), device)
    batches = [pipe.next_batch() for _ in range(steps)]
    out = {}
    for conf in configs:
        tag = conf_tag(conf)
        step = step_lib.make_train_step(cfg, train_tcfg(conf), dp=dp, device=device)
        state = step.init_state(torch.Generator(device=device).manual_seed(0))
        msgs.take()
        for i in range(steps):
            state, m = step(state, batches[i])
            _record(out, f"{tag}/step{i + 1}", state, m, msgs.take(), world=False,
                    replica=False)
            if save and tag in save and i == 0:
                Checkpointer(save[tag]).save(1, convert.train_state_to_reference(state),
                                             extra={"dp": dp}, block=True)
    return out


def train_forced(mesh, rank, device, *, dp: int, runs: dict) -> dict:
    """Teacher-forced world steps of the smoke ``llama3.2-1b``: ``runs``
    maps a tag to (its TrainConfig, [(every rank's state before the step,
    the step's global batch), ...]); each step starts from this rank's
    state and runs its shard of the batch, and the state after it and the
    step's metrics are recorded as :func:`train_world` records them."""
    from repro_torch.configs import registry
    from repro_torch.distributed import step as step_lib
    from repro_torch.distributed.gradsync.common import rank_shards

    cfg = registry.get_smoke_config(TRAIN_ARCH)
    msgs = MonitorMessages()
    out = {}
    for tag, (tcfg, steps) in runs.items():
        step = step_lib.make_train_step(cfg, tcfg, dp=dp, device=device, mesh=mesh)
        for i, (states, batch) in enumerate(steps):
            msgs.take()
            state, m = step(states[rank], rank_shards(batch, dp)[rank])
            _record(out, f"{tag}step{i + 1}", state, m, msgs.take(), world=True, replica=False)
    return out


def gspmd_forced(mesh, rank, device, *, runs: dict, ckpt: dict = None) -> dict:
    """Teacher-forced ``gspmd`` world steps over a ``("data",)`` or
    ``("data", "model")`` mesh: ``runs`` maps a tag to (arch, its
    TrainConfig, [(the stacked-layout state before the step, global
    leaves, the step's global batch), ...]).  Each step starts from this
    rank's blocks of the state (``GspmdStep.rank_state``) and runs its
    ``"data"`` shard of the batch; rank 0 records the state after it,
    gathered to global leaves and nested as the reference nests it, and
    every rank the step's metrics.  With ``ckpt`` the world also runs
    :func:`gspmd_checkpoint`."""
    from repro_torch.configs import registry
    from repro_torch.distributed import step as step_lib
    from repro_torch.distributed.gradsync.common import rank_shards

    dp = mesh.size(mesh.mesh_dim_names.index("data"))
    out = {}
    for tag, (arch, tcfg, steps) in runs.items():
        cfg = registry.get_smoke_config(arch)
        step = step_lib.make_train_step(cfg, tcfg, dp=dp, device=device, mesh=mesh)
        r = mesh.get_local_rank("data")
        for i, (state, batch) in enumerate(steps):
            new, m = step(step.rank_state(to(state, device)),
                          to(rank_shards(batch, dp)[r], device))
            _record_global(out, f"{tag}step{i + 1}", step, new, m)
    if ckpt:
        out.update(gspmd_checkpoint(mesh, device, **ckpt))
    return out


def _record_global(out: dict, prefix: str, step, state, metrics) -> None:
    from repro_torch.models import convert

    g = step.global_state(state, "cpu")
    if g is not None:
        tree = convert.train_state_to_reference(g)
        out.update({k: v.detach().clone() for k, v in flat(tree, f"{prefix}/state").items()})
    for k in ("loss", "grad_norm", "converged", "monitor_value", "aux_loss"):
        if k in metrics:
            out[f"{prefix}/metrics/{k}"] = metrics[k].detach().clone()


def gspmd_checkpoint(mesh, device, *, arch: str, tcfg, batches: list, directory: str) -> dict:
    """A ``gspmd`` world trains ``arch`` from seed 0 on ``batches`` (global),
    saves after step 1 through the trainer's own path
    (``launch.train.save_global``: global leaves, written by rank 0 one at
    a time), resumes from it (``restore_global``, with ``np.load`` barred:
    each rank reads its blocks through ``np.memmap``) and runs the steps
    after again; rank 0 records both runs' states (global leaves) and
    metrics under ``ckpt/run`` and ``ckpt/resumed``, and the save's bytes
    and largest leaf (``ckpt/save``); every rank the bytes its restore
    copied out of the file beside those of its own param and optimizer
    blocks (``ckpt/read``)."""
    from unittest import mock

    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import registry
    from repro_torch.distributed import step as step_lib
    from repro_torch.distributed.gradsync.common import rank_shards
    from repro_torch.launch import train as train_cli

    cfg = registry.get_smoke_config(arch)
    dp = mesh.size(mesh.mesh_dim_names.index("data"))
    tp = mesh.size(mesh.mesh_dim_names.index("model")) if "model" in mesh.mesh_dim_names else 1
    step = step_lib.make_train_step(cfg, tcfg, dp=dp, device=device, mesh=mesh)
    r = mesh.get_local_rank("data")
    shards = [to(rank_shards(b, dp)[r], device) for b in batches]
    ck = Checkpointer(directory)
    state = step.init_state(torch.Generator(device=device).manual_seed(0))
    out = {}
    for i, b in enumerate(shards):
        state, m = step(state, b)
        _record_global(out, f"ckpt/run/step{i + 1}", step, state, m)
        if i == 0:
            train_cli.save_global(ck, state, step, {"dp": dp, "tp": tp})
            dist.barrier()
            # the bytes of the rank's own blocks of the params and optimizer
            mine = sum(t.numel() * t.element_size()
                       for t in flat({"p": state["params"], "o": state["opt"]}, "").values())
    if ck.saves:  # rank 0, the writer
        out["ckpt/save"] = torch.tensor([ck.saves[0]["bytes"], ck.saves[0]["peak_bytes"]])
    # the restore reads the rank's blocks through np.memmap, never the archive whole
    with mock.patch.object(np, "load", side_effect=AssertionError("np.load of the archive")):
        state = train_cli.restore_global(ck, 1, step, device)
    out["ckpt/read"] = torch.tensor([ck.restores[0]["bytes"], mine])
    for i in range(1, len(shards)):
        state, m = step(state, shards[i])
        _record_global(out, f"ckpt/resumed/step{i + 1}", step, state, m)
    return out


def mrd_tp_forced(mesh, rank, device, *, runs: dict, free: dict = None,
                  ckpt: dict = None) -> dict:
    """Teacher-forced MRD world steps over a ``("data", "model")`` mesh:
    ``runs`` maps a tag to (arch, its TrainConfig, [(the stacked-layout
    state before the step, the reference's state after it, both over the
    whole params; the step's global batch), ...]).  Each step starts from
    this coordinate's part of the state before (the step's
    ``rank_state``) and runs its ``"data"`` shard of the batch; every rank
    records under ``<tag>step<i>/`` its part of the state before
    (``before``), the reference's state after mapped onto its part
    (``want``), its own state after (``got``), the metrics, and under
    ``compressed`` its fp32 gradient buckets at the state before
    (``grad``, whole padded vector) and which buckets hold leaves
    replicated over ``"model"`` (``<tag>replicated``).  ``free`` ({tag:
    (arch, TrainConfig, [global batches])}) runs from the seed-0 init
    and records, after the last step, the leaves replicated over
    ``"model"`` and their EF residual (``<tag>free/``).  With ``ckpt``
    the world also runs :func:`mrd_tp_checkpoint`."""
    from repro_torch.collectives import buckets
    from repro_torch.configs import registry
    from repro_torch.distributed import step as step_lib
    from repro_torch.distributed.gradsync import common
    from repro_torch.distributed.gradsync.common import rank_shards
    from repro_torch.models import convert

    dp = mesh.size(mesh.mesh_dim_names.index("data"))
    r = mesh.get_local_rank("data")
    out = {}

    def record(prefix, state, replica):
        tree, _ = convert.rank_state_to_reference(state, replica=replica)
        out.update({k: v.detach().clone() for k, v in flat(tree, prefix).items()})

    for tag, (arch, tcfg, steps) in runs.items():
        cfg = registry.get_smoke_config(arch)
        step = step_lib.make_train_step(cfg, tcfg, dp=dp, device=device, mesh=mesh)
        replica = tcfg.grad_sync == "local_sgd"
        for i, (before, after, batch) in enumerate(steps):
            prefix = f"{tag}step{i + 1}"
            mine = step.rank_state(to(before, device))
            record(f"{prefix}/before", mine, replica)
            record(f"{prefix}/want", step.rank_state(to(after, device)), replica)
            shard = to(rank_shards(batch, dp)[r], device)
            if tcfg.grad_sync == "compressed":
                layout, _ = step._layout(mine["params"])
                with common.model_region(step.tp):
                    bufs, _, _ = common.rank_grad_buckets(mine["params"], shard, cfg, tcfg,
                                                          layout)
                out[f"{prefix}/grad"] = torch.cat(bufs)
                out[f"{tag}replicated"] = torch.tensor(
                    [step.groups[b.slots[0].index] for b in layout.buckets])
                out[f"{tag}bucket_lengths"] = torch.tensor(layout.bucket_lengths)
            new, m = step(mine, shard)
            record(f"{prefix}/got", new, replica)
            for k in ("loss", "grad_norm", "converged", "monitor_value", "aux_loss"):
                if k in m:
                    out[f"{prefix}/metrics/{k}"] = m[k].detach().clone()
    for tag, (arch, tcfg, batches) in (free or {}).items():
        cfg = registry.get_smoke_config(arch)
        step = step_lib.make_train_step(cfg, tcfg, dp=dp, device=device, mesh=mesh)
        state = step.init_state(torch.Generator(device=device).manual_seed(0))
        for b in batches:
            state, _ = step(state, to(rank_shards(b, dp)[r], device))
        leaves, paths = buckets.tree_flatten(convert.reference_tree(state["params"]))
        for leaf, path, rep in zip(leaves, paths, step.groups):
            if rep:
                out[f"{tag}free/params/" + "/".join(path)] = leaf.detach().clone()
        layout, _ = step._layout(state["params"])
        efs = torch.split(state["opt"]["ef"], layout.bucket_lengths)
        out[f"{tag}free/ef"] = torch.cat([e for e, b in zip(efs, layout.buckets)
                                          if step.groups[b.slots[0].index]])
    if ckpt:
        out.update(mrd_tp_checkpoint(mesh, device, **ckpt))
    return out


def mrd_tp_checkpoint(mesh, device, *, arch: str, tcfg, batches: list, directory: str) -> dict:
    """An MRD world at ``tp`` > 1 trains ``arch`` from seed 0 on ``batches``
    (global), saves after step 1 through the trainer's path (every rank
    its blocks and rows, ``launch.train.to_reference``), resumes from it
    (``launch.train.resume``) and runs the steps after again; every rank
    records both runs' states under ``ckpt/run`` and ``ckpt/resumed``, and
    whether a resume at another ``tp`` was refused (``ckpt/refused``)."""
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import registry
    from repro_torch.distributed import step as step_lib
    from repro_torch.distributed.gradsync.common import rank_shards
    from repro_torch.launch import train as train_cli
    from repro_torch.models import convert

    class Cursor:  # the data pipeline's part of a resume
        def load_state_dict(self, d):
            self.loaded = d

    cfg = registry.get_smoke_config(arch)
    dp = mesh.size(mesh.mesh_dim_names.index("data"))
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    step = step_lib.make_train_step(cfg, tcfg, dp=dp, device=device, mesh=mesh)
    r = mesh.get_local_rank("data")
    shards = [to(rank_shards(b, dp)[r], device) for b in batches]
    ck = Checkpointer(directory, world=(dist.get_rank(), dist.get_world_size()))
    state = step.init_state(torch.Generator(device=device).manual_seed(0))
    out = {}

    def record(prefix, st):
        tree, _ = convert.rank_state_to_reference(st)
        out.update({k: v.detach().clone() for k, v in flat(tree, prefix).items()})

    for i, b in enumerate(shards):
        state, _ = step(state, b)
        record(f"ckpt/run/step{i + 1}", state)
        if i == 0:
            tree, rows = train_cli.to_reference(state, ck, tcfg.grad_sync, tp)
            ck.save(1, tree, extra={"data": {}, "dp": dp, "tp": tp}, block=True, rows=rows)
            dist.barrier()
    try:
        train_cli.resume(ck, state, cfg, Cursor(), dp, device, tcfg.grad_sync, step, mesh, 1)
        out["ckpt/refused"] = torch.tensor(False)
    except ValueError as e:
        out["ckpt/refused"] = torch.tensor("tp=" in str(e))
    state, step0 = train_cli.resume(ck, state, cfg, Cursor(), dp, device, tcfg.grad_sync, step,
                                    mesh, tp)
    assert step0 == 1
    for i in range(1, len(shards)):
        state, _ = step(state, shards[i])
        record(f"ckpt/resumed/step{i + 1}", state)
    return out


OVERLAP_MODES = ("mrd_zero1", "compressed", "mrd_paper", "mrd_leaf")


def overlap_world(mesh, rank, device, *, arch: str, steps: int, batch: int,
                  microbatches: int = 1) -> dict:
    """Every gradient-scale mode of :data:`OVERLAP_MODES` trains ``arch``
    from seed 0 for ``steps`` steps with ``overlap`` off and on, as this
    rank of a ``("data",)`` or ``("data", "model")`` world; every rank
    records its state after each step (``<mode>/<off|on>/step<i>/``) and
    the metrics."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import step as step_lib
    from repro_torch.models import convert

    cfg = registry.get_smoke_config(arch)
    dp = mesh.size(mesh.mesh_dim_names.index("data"))
    pipe = SyntheticPipeline(cfg, DataConfig(batch=batch, seq_len=TRAIN_SEQ, seed=0), device,
                             rank=mesh.get_local_rank("data"), dp=dp)
    batches = [pipe.next_batch() for _ in range(steps)]
    out = {}
    for mode in OVERLAP_MODES:
        for on in (False, True):
            tcfg = dataclasses.replace(train_tcfg({"mode": mode, "microbatches": microbatches}),
                                       overlap=on)
            step = step_lib.make_train_step(cfg, tcfg, dp=dp, device=device, mesh=mesh)
            state = step.init_state(torch.Generator(device=device).manual_seed(0))
            for i, b in enumerate(batches):
                state, m = step(state, b)
                prefix = f"{mode}/{'on' if on else 'off'}/step{i + 1}"
                tree, _ = convert.rank_state_to_reference(state)
                out.update({k: v.detach().clone() for k, v in flat(tree, prefix).items()})
                for k in ("loss", "grad_norm", "monitor_value"):
                    out[f"{prefix}/metrics/{k}"] = m[k].detach().clone()
    return out


def serve_cli(mesh, rank, device, *, runs: dict) -> dict:
    """The serving CLI's run (``launch.serve.run``, the entry a
    ``torch.distributed.run`` rank takes after joining its world) for
    every ``runs`` entry whose world is this one: ``runs`` maps a tag to
    (argv, the whole weights as a port param dict, the static path's
    prompt or None).  Each rank serves with its blocks of the weights;
    every rank records each request's output tokens, admission and
    retirement ticks (the static path: its tokens [batch, gen])."""
    import functools

    from repro_torch.configs import registry
    from repro_torch.distributed import serve as dserve
    from repro_torch.launch import serve as cli
    from repro_torch.serving import make_workload

    out = {}
    for tag, (argv, params, prompt) in runs.items():
        args = cli.build_parser().parse_args(list(argv) + ["--device", str(device)])
        cfg = registry.get_smoke_config(args.arch)
        mine = dserve.shard_params(to(params, device), cfg, mesh)
        saved = cli.make_workload, cli.static_serve
        cli.make_workload = functools.partial(make_workload, params=mine)
        cli.static_serve = functools.partial(cli.static_serve, params=mine, prompt=prompt)
        try:
            got = cli.run(args, mesh)
        finally:
            cli.make_workload, cli.static_serve = saved
        if not args.continuous:
            out[f"{tag}tokens"] = torch.from_numpy(got["tokens"])
            continue
        for i, r in got.results.items():
            out[f"{tag}{i}/output"] = torch.as_tensor(np.asarray(r.output))
            out[f"{tag}{i}/ticks"] = torch.tensor([r.admit_tick, r.retire_tick, r.n_tokens])
    return out


# the gspmd world cases of test_torch_gspmd_world.py (and on NCCL,
# test_torch_tp_nccl.py): tag -> (arch, (dp, tp), TrainConfig fields,
# global batch or None for 2 dp)
GSPMD_CASES = {
    "llama-tp4/": ("llama3.2-1b", (1, 4), {}, None),
    "minicpm-tp4/": ("minicpm-2b", (1, 4), {}, None),
    "qwen-tp2/": ("qwen2.5-32b", (1, 2), {}, None),
    "falcon-tp2/": ("falcon-mamba-7b", (1, 2), {}, None),
    "zamba2-tp2/": ("zamba2-2.7b", (1, 2), {}, None),
    "mixtral-dp2/": ("mixtral-8x7b", (2, 1), {}, None),
    "internvl2-dp2/": ("internvl2-1b", (2, 1), {"remat": "dots"}, None),
    "llama-dp2tp2/": ("llama3.2-1b", (2, 2), {"remat": "full", "microbatches": 2}, 8),
    "gemma3-dp2tp2/": ("gemma3-12b", (2, 2), {"remat": "dots"}, None),
    "hubert-dp2tp2/": ("hubert-xlarge", (2, 2), {}, None),
}
GSPMD_LR = 1e-2
# the MRD modes at tp > 1 of test_torch_mrd_tp.py (and on NCCL,
# test_torch_mrd_tp_nccl.py): tag -> (arch, grad-sync mode, (dp, tp),
# TrainConfig fields); the bucket cap of the recordings (32 KiB) splits
# the smoke models into several buckets
MRD_TP_CASES = {}
for _mesh in ((2, 2), (3, 2)):
    _m = f"{_mesh[0]}x{_mesh[1]}"
    for _mode in ("mrd_zero1", "compressed", "mrd_paper", "mrd_leaf", "local_sgd"):
        MRD_TP_CASES[f"llama-{_mode}-{_m}/"] = (
            "llama3.2-1b", _mode, _mesh, {"local_sync_every": 2} if _mode == "local_sgd" else {})
MRD_TP_CASES.update({
    "mixtral-mrd_zero1-2x2/": ("mixtral-8x7b", "mrd_zero1", (2, 2), {}),
    "mixtral-mrd_leaf-2x2/": ("mixtral-8x7b", "mrd_leaf", (2, 2), {}),
    "falcon-compressed-2x2/": ("falcon-mamba-7b", "compressed", (2, 2), {}),
    "falcon-mrd_zero1-2x2/": ("falcon-mamba-7b", "mrd_zero1", (2, 2), {}),
})
# the TP serving cases of test_torch_serving_tp.py: tag -> (tp, argv)
SERVE_COMMON = ["--smoke", "--continuous", "--dp", "3", "--slots", "3", "--requests", "6"]
SERVE_CASES = {
    "llama-tp2/": (2, ["--arch", "llama3.2-1b", "--workload", "llm_decode_paged"]),
    "llama-tp4/": (4, ["--arch", "llama3.2-1b", "--workload", "llm_decode_paged"]),
    "qwen-tp2/": (2, ["--arch", "qwen2.5-32b", "--workload", "llm_decode_paged"]),
    "qwen-tp4/": (4, ["--arch", "qwen2.5-32b", "--workload", "llm_decode_paged"]),
    "mixtral-tp2/": (2, ["--arch", "mixtral-8x7b", "--workload", "llm_decode",
                         "--prompt-len", "40", "--gen", "20"]),
    "falcon-tp2/": (2, ["--arch", "falcon-mamba-7b", "--workload", "llm_decode",
                        "--prompt-len", "24", "--gen", "20"]),
    "zamba2-tp2/": (2, ["--arch", "zamba2-2.7b", "--workload", "llm_decode_paged"]),
}
SERVE_STATIC = {"arch": "llama3.2-1b", "batch": 4, "prompt_len": 8, "gen": 6, "dp": 2, "tp": 2}


def mesh_shape(mesh):
    """(shape, dimension names) of a (dp, tp) world."""
    return (mesh, ("data", "model")) if mesh[1] > 1 else (mesh[:1], ("data",))


def gspmd_tcfg(**kw):
    """The TrainConfig of the gspmd world cases (the recordings')."""
    from repro_torch.distributed import step as step_lib
    from repro_torch.optim.optimizer import OptimizerConfig

    base = dict(microbatches=1, remat="none")
    base.update(kw)
    return step_lib.TrainConfig(
        grad_sync="gspmd", monitor=True, monitor_mode="inexact", monitor_threshold=6.0,
        bucket_bytes=1 << 15, optimizer=OptimizerConfig(
            lr=GSPMD_LR, schedule="const", warmup_steps=0, grad_clip=1.0), **base)


NOISE = 1e-7  # a gradient coordinate this close to zero takes its sign from summation order


def close_states(got: dict, want: dict, before: dict, what, lr: float = GSPMD_LR) -> None:
    """Two flat train states (``flat`` of the reference nesting, keys
    ``state/params/...``, ``state/opt/mu/...``) after the same AdamW step
    from the same state ``before``, summed in other orders, held as
    ``test_torch_train_families``' exact-sync rule holds them: params and
    masters within 5e-4 but for the coordinates whose gradient (from the
    first moment, ``(mu' - beta1 mu) / (1 - beta1)``) is within ``NOISE``
    of zero, which AdamW moves by up to 2 x lr either way; the moments
    within 1e-5; the monitor's integers exactly, its floats within 1e-6
    relative."""
    b1 = 0.9
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if not g.is_floating_point():
            assert torch.equal(g, w), (what, k)
            continue
        if "/monitor/" in k:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0, msg=f"{what} {k}")
            continue
        d = (g.float() - w.float()).abs()
        if "/opt/mu/" in k or "/opt/nu/" in k:
            assert float(d.max()) <= 1e-5, (what, k, float(d.max()))
            continue
        leaf = k.split("/params/", 1)[1] if "/params/" in k else k.split("/opt/master/", 1)[1]
        mu = want[f"state/opt/mu/{leaf}"]
        noise = ((mu - b1 * before[f"state/opt/mu/{leaf}"]) / (1 - b1)).abs() <= NOISE
        assert float(d.max()) <= 2 * lr, (what, k, float(d.max()))
        worst = float(d[~noise].max()) if bool((~noise).any()) else 0.0
        assert worst <= 5e-4, (what, k, worst)


# ---------------------------------------------------------------------------
# Checks of the MRD worlds at tp > 1 (test_torch_mrd_tp.py against the
# reference, test_torch_mrd_tp_nccl.py against the stacked-rows step)
# ---------------------------------------------------------------------------

MRD_LR, MRD_BUCKET_BYTES = 1e-2, 1 << 15
MRD_MONITOR_MODES = {"mrd_zero1": "exact", "compressed": "inexact"}
# the exact run whose step-1 gradient each compressed case is held to
MRD_EXACT_OF = {"llama-compressed-2x2/": "llama-mrd_zero1-2x2/",
                "llama-compressed-3x2/": "llama-mrd_zero1-3x2/",
                "falcon-compressed-2x2/": "falcon-mrd_zero1-2x2/"}
B1 = 0.9


def mrd_tcfg(mode: str, **kw):
    """The TrainConfig of the MRD cases (``test_torch_train_families``'
    ``train_tcfg``, the recordings')."""
    from repro_torch.distributed import step as step_lib
    from repro_torch.optim.optimizer import OptimizerConfig

    base = dict(microbatches=1, remat="none")
    base.update(kw)
    return step_lib.TrainConfig(
        grad_sync=mode, monitor=mode != "local_sgd",
        monitor_mode=MRD_MONITOR_MODES.get(mode, "inexact"), monitor_threshold=6.0,
        bucket_bytes=MRD_BUCKET_BYTES, optimizer=OptimizerConfig(
            lr=MRD_LR, schedule="const", warmup_steps=0, grad_clip=1.0), **base)


def part(rec: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rec.items() if k.startswith(prefix)}


def ranks_of(mesh):
    """(world rank, data rank, model rank) of every coordinate of a (dp,
    tp) mesh."""
    return [(d * mesh[1] + m, d, m) for d in range(mesh[0]) for m in range(mesh[1])]


def replicated(cfg, mesh) -> list:
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.gradsync import common
    from repro_torch.models import transformer

    rules = shd.make_rules(cfg, {"data": mesh[0], "model": mesh[1]}, fsdp=False)
    return common.replicated_leaves(shd.param_specs(cfg, rules, transformer.param_shapes(cfg)))


def _noise(mu, mu0):
    return ((mu - B1 * mu0) / (1 - B1)).abs() <= NOISE


def _check_masked(d, mask, what):
    assert float(d.max()) <= 2 * MRD_LR, (what, float(d.max()))
    worst = float(d[~mask].max()) if bool((~mask).any()) else 0.0
    assert worst <= 5e-4, (what, worst)


def check_mrd_metrics(m: dict, want: dict, mode: str, what) -> None:
    """A step's metrics against the reference's (``test_torch_train_families``'
    rule): loss atol 1e-5, grad norm rtol 1e-4 (5e-4 compressed),
    ``converged`` exact, the published value rtol 1e-6."""
    assert abs(float(m["loss"]) - float(want["loss"])) <= 1e-5, (what, float(m["loss"]))
    rtol = 5e-4 if mode == "compressed" else 1e-4
    np.testing.assert_allclose(float(m["grad_norm"]), float(want["grad_norm"]), rtol=rtol,
                               err_msg=str(what))
    assert bool(m["converged"]) == bool(want["converged"]), what
    np.testing.assert_allclose(float(m["monitor_value"]), float(want["monitor_value"]),
                               rtol=1e-6, err_msg=str(what))


def _check_common(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
        if k.startswith("monitor/"):
            if g.is_floating_point():
                torch.testing.assert_close(g, w, rtol=1e-6, atol=0, msg=f"{what} {k}")
            else:
                assert torch.equal(g, w), (what, k)


def _unflat(d: dict) -> dict:
    out: dict = {}
    for k, v in d.items():
        node = out
        *path, last = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def check_mrd_exact(cfg, mesh, mode, recs, r, d, prefix, what) -> None:
    """An exact mode's state after a teacher-forced step against the
    reference's mapped onto the coordinate: masters and params within 5e-4
    but for the coordinates whose gradient (from the first moment) is
    within ``NOISE`` of zero, which may move up to 2 x lr; moments within
    1e-5; the monitor as :func:`close_states` holds it."""
    from repro_torch.distributed.gradsync.mrd_zero1 import zero1_master_row
    from repro_torch.models import convert

    got, want, before = (part(recs[r], f"{prefix}/{p}") for p in ("got/", "want/", "before/"))
    _check_common(got, want, what)
    for k in want:
        if k.startswith("opt/mu") or k.startswith("opt/nu"):
            assert float((got[k] - want[k]).abs().max()) <= 1e-5, (what, k)
    if mode in ("mrd_zero1", "mrd_paper"):
        mask = _noise(want["opt/mu"], before["opt/mu"])
        _check_masked((got["opt/master"] - want["opt/master"]).abs(), mask, (what, "master"))
        dpar = convert.port_tree(_unflat({k[len("params/"):]: (got[k].float() - v.float()).abs()
                                          for k, v in want.items() if k.startswith("params/")}))
        row = zero1_master_row(dpar, mesh[0], d, bucket_bytes=MRD_BUCKET_BYTES,
                               paper_mode=mode == "mrd_paper", groups=replicated(cfg, mesh))
        _check_masked(row, mask, (what, "params"))
        return
    # tree-shaped optimizers: a mask a leaf; a local_sgd replica's params
    # after an average carry the noise of every replica of its model column
    column = [rr for rr, _, m in ranks_of(mesh) if m == r % mesh[1]]
    for k in want:
        if not k.startswith("opt/master/"):
            continue
        leaf = k[len("opt/master/"):]
        mask = _noise(want[f"opt/mu/{leaf}"], before[f"opt/mu/{leaf}"])
        _check_masked((got[k] - want[k]).abs(), mask, (what, k))
        pmask = mask
        if mode == "local_sgd":
            for rr in column:
                o_want, o_before = (part(recs[rr], f"{prefix}/{p}") for p in ("want/", "before/"))
                pmask = pmask | _noise(o_want[f"opt/mu/{leaf}"], o_before[f"opt/mu/{leaf}"])
        p = f"params/{leaf}"
        _check_masked((got[p].float() - want[p].float()).abs(), pmask, (what, p))


def _owned(vec, lengths, dp: int, d: int):
    from repro_torch.distributed.gradsync.mrd_zero1 import zero1_owner_segments, zero1_prod_p0

    own, p0 = zero1_owner_segments(dp)[d], zero1_prod_p0(dp)
    return torch.cat([b.reshape(p0, -1)[own] for b in torch.split(vec, lengths)])


def check_mrd_compressed(recs, mesh, tag, i, exact_grad_norm) -> None:
    """A ``compressed`` step at ``tp`` > 1 on every coordinate: the EF
    invariant bit for bit (``dequant(quant(grad + old residual)) + new
    residual == grad + old residual``), params and masters within 2 x lr
    of the reference's; at step 1 (``i`` 0, the exact run's init) the
    decoded mean gradient, from the first moment, within the int8 bound of
    the exact run's (``exact_grad_norm``: its step-1 grad norm): half a
    quantum of the block's scale for each rank's own EF round trip and for
    each reducing stage, whose block scale is at most the block's largest
    sum of the column's absolute gradients over 127."""
    from repro_torch.collectives import transforms as tf_lib
    from repro_torch.distributed.gradsync.mrd_zero1 import zero1_owner_segments, zero1_prod_p0

    prefix = f"{tag}step{i + 1}"
    lengths = recs[0][f"{tag}bucket_lengths"].tolist()
    dp = mesh[0]
    for r, d, m in ranks_of(mesh):
        what = (tag, i + 1, r)
        got, want, before = (part(recs[r], f"{prefix}/{p}") for p in ("got/", "want/", "before/"))
        _check_common(got, want, what)
        grad, old, new = recs[r][f"{prefix}/grad"], before["opt/ef"], got["opt/ef"]
        sent = grad.clone().add_(old)
        wire = tf_lib.dequantize(*tf_lib.quantize(sent, tf_lib.BLOCK), tf_lib.BLOCK)
        assert torch.equal(wire + new, sent), what
        assert bool((new != 0).any()), what
        for k in want:
            if k == "opt/master" or k.startswith("params/"):
                d_max = float((got[k].float() - want[k].float()).abs().max())
                assert d_max <= 2 * MRD_LR, (what, k, d_max)
        if i or zero1_owner_segments(dp)[d] is None:
            continue
        exact_tag = MRD_EXACT_OF[tag]
        scale = min(1.0, 1.0 / float(recs[r][f"{prefix}/metrics/grad_norm"]))
        g = got["opt/mu"] / (1 - B1) / scale
        # the exact run's first moment after step 1, as this coordinate's
        # row (the worker mapped it: that case's want)
        g_ref = part(recs[r], f"{exact_tag}step1/want/")["opt/mu"] / (1 - B1) / min(
            1.0, 1.0 / exact_grad_norm)
        column = [rr for rr, _, mm in ranks_of(mesh) if mm == m]

        def block_max(x):
            return x.reshape(-1, tf_lib.BLOCK).amax(1).repeat_interleave(tf_lib.BLOCK)

        grads = [recs[rr][f"{prefix}/grad"].abs() for rr in column]
        stages = int(dp & (dp - 1) != 0) + int(np.log2(zero1_prod_p0(dp)))
        quanta = sum(block_max(x) for x in grads) + stages * block_max(sum(grads))
        bound = _owned(quanta, lengths, dp, d) / 254 / dp
        err = (g - g_ref).abs()
        assert bool((err <= bound + 1e-5 * g_ref.abs() + 1e-8).all()), (
            what, float((err - bound).max()))
        assert float(err.max()) > 0, what  # the int8 wire is lossy here


def check_mrd_case(recs, mesh, tag, mode, cfg, metrics_of, exact_grad_norm=None,
                   steps: int = 2) -> None:
    """Every teacher-forced step of an MRD case at ``tp`` > 1 on every
    coordinate: metrics against ``metrics_of(i)`` (the reference's of step
    ``i``), the state as :func:`check_mrd_exact` or
    :func:`check_mrd_compressed` holds it."""
    for i in range(steps):
        prefix = f"{tag}step{i + 1}"
        for r, d, _ in ranks_of(mesh):
            m = part(recs[r], f"{prefix}/metrics/")
            check_mrd_metrics(m, metrics_of(i), mode, (tag, i, r))
            if mode != "compressed":
                check_mrd_exact(cfg, mesh, mode, recs, r, d, prefix, (tag, i + 1, r))
        if mode == "compressed":
            check_mrd_compressed(recs, mesh, tag, i, exact_grad_norm)


def check_mrd_free_and_ckpt(recs, free_tag: str, ckpt_steps: int) -> None:
    """After free-running ``compressed`` steps the leaves replicated over
    ``"model"`` and their EF residual are bit-equal on the model ranks of
    each data rank of a (dp, 2) world; its checkpoint resumes bit for bit
    and refuses another ``tp``."""
    for d in range(len(recs) // 2):
        a, b = (part(recs[d * 2 + m], f"{free_tag}free/") for m in range(2))
        assert sorted(a) == sorted(b) and any(k.startswith("params/") for k in a)
        for k in a:
            assert torch.equal(a[k], b[k]), (d, k)
        assert bool((a["ef"] != 0).any())
    for rec in recs:
        assert bool(rec["ckpt/refused"])
        for i in range(2, ckpt_steps + 1):
            run, resumed = part(rec, f"ckpt/run/step{i}/"), part(rec, f"ckpt/resumed/step{i}/")
            assert sorted(run) == sorted(resumed) and run
            for k, v in run.items():
                assert torch.equal(v, resumed[k]), (i, k)


SCENARIOS = {"one_axis": one_axis, "two_axis": two_axis, "monitor": monitor,
             "mismatched": mismatched, "train": train_world, "train_forced": train_forced,
             "gspmd_forced": gspmd_forced, "serve_cli": serve_cli,
             "mrd_tp_forced": mrd_tp_forced, "overlap_world": overlap_world}


# ---------------------------------------------------------------------------
# What the sim executor gives on the same stacked inputs
# ---------------------------------------------------------------------------


def sim_one_axis(p: int, seed: int) -> dict:
    """The sim executor on the stacked inputs of every :func:`one_axis`
    entry (keyed without the executor)."""
    from repro_torch.collectives import plans

    n = one_axis_length(p)
    X = torch.from_numpy(stacked_inputs(p, n, seed))
    tree = stacked_tree(p, seed + 1)
    out = {}
    for op in OPS:
        out[f"mrd_{op}"] = plans.allreduce_plan(op=op, p=p).run(X)
    out["mrd_blocking"] = plans.allreduce_plan(p=p).run_blocking(X)
    for tf in TRANSFORMS:
        out[f"mrd_{tf}"] = plans.allreduce_plan(transform=tf, p=p).run(X)
        out[f"rabenseifner_{tf}"] = plans.allreduce_plan(
            schedule="rabenseifner", transform=tf, p=p).run(X)
        out[f"rs_{tf}"] = plans.reduce_scatter_plan(transform=tf, p=p).run(X)
        out[f"rsag_{tf}"] = plans.allgather_plan(p=p).run(out[f"rs_{tf}"])
        for sched in ("mrd", "rabenseifner"):
            out.update(flat(plans.tree_allreduce(
                tree, schedule=sched, transform=tf, p=p, bucket_bytes=TREE_BUCKET_BYTES),
                f"tree_{sched}_{tf}"))
    plan = plans.allreduce_plan(schedule="rabenseifner", transform="int8", p=p)
    for k, b in enumerate(plan.run_buffers([X[:, : n // 2], X, X[:, n // 2:]])):
        out[f"pipeline_{k}"] = b
    out["int8_block128"] = plans.allreduce_plan(
        schedule="rabenseifner", transform="int8", block=128, p=p).run(X)
    return out


def entries(d: dict, base: str, ex: str = "") -> dict:
    """The entries of ``d`` that scenario ``base`` produced (every leaf of a
    tree, every bucket of the pipeline), keyed without the executor."""
    out = {}
    for k, v in d.items():
        head, sep, tail = k.partition("/")
        if ex:
            if not head.endswith(f"_{ex}"):
                continue
            head = head[: -len(ex) - 1]
        if head == base or (base == "pipeline" and head.startswith("pipeline_")):
            out[head + sep + tail] = v
    return out


def sim_chained(X, schedule: str, axes, transform: str, mesh_names):
    """The chained plan emulated with one-axis sim plans: each phase runs
    on every line of the mesh along its axis.  ``X`` is [*mesh, n], its
    dimensions named ``mesh_names``."""
    from repro_torch.collectives import plans, schedules
    from repro_torch.collectives.schedules import Phase

    for ph in schedules.get_schedule(schedule).phases(len(axes)):
        d = mesh_names.index(axes[ph.axis_index])
        Xd = X.movedim(d, 0)
        plan = plans.CollectivePlan(schedule=schedule, transform=transform, p=Xd.shape[0],
                                    phases=(Phase(ph.collective, 0),))
        X = torch.stack([plan.run(Xd[:, j].contiguous()) for j in range(Xd.shape[1])],
                        dim=1).movedim(0, d)
    return X


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------


def _worker(rank, world, store, mesh_shape, mesh_names, scenario, args, out_dir, pg_timeout,
            device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    try:
        kw = {}
        if device == "cuda":  # one card a rank, set before the group and the mesh
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"file://{store}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=pg_timeout), **kw)
        try:
            mesh = init_device_mesh(device, mesh_shape, mesh_dim_names=mesh_names)
            result = SCENARIOS[scenario](mesh, rank, device, **args)
            torch.save(to(result, "cpu"), out_dir / f"rank{rank}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_world(tmp_dir, scenario: str, mesh_shape, mesh_names, *, args=None,
              deadline_s: float = 90.0, pg_timeout_s: float = 45.0, device: str = "cpu") -> list:
    """Run ``scenario`` in a world of ``prod(mesh_shape)`` spawned ranks
    (gloo on the CPU; NCCL with ``device="cuda"``, one card a rank);
    returns each rank's dict, on the CPU.  Raises :class:`WorldFailed`
    when a rank fails or the world outlives ``deadline_s``."""
    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    world = int(np.prod(mesh_shape))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, daemon=True, args=(
        r, world, str(tmp_dir / "store"), tuple(mesh_shape), tuple(mesh_names), scenario,
        args or {}, str(tmp_dir), pg_timeout_s, device)) for r in range(world)]
    for proc in procs:
        proc.start()
    end = time.monotonic() + deadline_s
    try:
        for proc in procs:
            proc.join(max(0.0, end - time.monotonic()))
    finally:
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    errs = {r: (tmp_dir / f"rank{r}.err").read_text() for r in range(world)
            if (tmp_dir / f"rank{r}.err").exists()}
    if hung:
        raise WorldFailed(f"{scenario}: ranks {hung} still running after {deadline_s} s; "
                          f"errors: {errs}")
    bad = {r: proc.exitcode for r, proc in enumerate(procs) if proc.exitcode != 0}
    if bad or errs:
        raise WorldFailed(f"{scenario}: exit codes {bad}; errors: {errs}")
    return [torch.load(tmp_dir / f"rank{r}.pt", weights_only=True) for r in range(world)]
