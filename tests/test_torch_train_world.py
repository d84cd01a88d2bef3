"""The multi-process trainer: one process a rank over a ``DeviceMesh``
(gloo on the CPU) against the stacked-rows trainer (the sim executor).

One world a rank count, 3 and 5 (the paper's non-power-of-two cases),
runs the smoke ``llama3.2-1b`` for 3 steps under every grad-sync mode
with AdamW, and under four of them with Lion or SGD, all at
``microbatches`` 2 (``compressed`` with its EF residuals), through
``tests/torch_dist_worker.py``'s ``train`` scenario.  The parent runs the
stacked-rows trainer on the same global batches.  Both compute each
rank's values with the same operations on the same inputs (a world
rank's batch shard is the sim's row's, its plans' stages are the sim's
per row, the device executors equal the sim bit for bit, and the logged
loss is gathered exactly), so after every step each rank's params,
optimizer rows, EF residuals, monitor rows, loss, grad norm and monitor
flags equal the sim's row bit for bit, and the monitor sends as many
messages.  One exception, by design: a ZeRO-1 rank that owns no segment
(ranks 2 at dp 3, rank 4 at dp 5) runs no optimizer update, so its
``master``/``mu``/``nu`` rows keep their initial zeros, where the sim,
as the reference, updates that row from stale values that nothing reads
(the all-gather's forward shift overwrites that rank's params).

At dp 3 the world also saves a checkpoint after step 1 under
``compressed``, ``mrd_leaf`` and ``local_sgd``: resumed in the world it
gives the uninterrupted run bit for bit, it restores in the sim trainer
and the sim's checkpoint restores in the world, and either continues as
the uninterrupted run (but for the non-owner rows above, which each
trainer treats its own way).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.device import rank_device  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.distributed.gradsync.mrd_zero1 import zero1_owner_segments  # noqa: E402
from repro_torch.models import convert  # noqa: E402

MODES = ("mrd_paper", "mrd_zero1", "compressed", "mrd_leaf", "local_sgd")
CONFIGS = ([{"mode": m} for m in MODES]
           + [{"mode": m, "optimizer": "lion"} for m in ("mrd_zero1", "mrd_leaf")]
           + [{"mode": m, "optimizer": "sgd"} for m in ("compressed", "local_sgd")])
TAGS = [W.conf_tag(c) for c in CONFIGS]
CKPT_TAGS = ("compressed-adamw", "mrd_leaf-adamw", "local_sgd-adamw")
STEPS = 3
ZERO1 = ("mrd_zero1", "compressed")  # the modes whose ranks may own no segment
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the world's ranks run
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[3, 5], ids=lambda p: f"p{p}")
def world(request, tmp_path_factory):
    p = request.param
    root = tmp_path_factory.mktemp(f"train_world{p}")
    ckpt = ({t: {"world": str(root / f"world_{t}"), "sim": str(root / f"sim_{t}")}
             for t in CKPT_TAGS} if p == 3 else None)
    sim = W.sim_train(p, CONFIGS, STEPS, 2 * p,
                      save={t: d["sim"] for t, d in ckpt.items()} if ckpt else None)
    ranks = W.run_world(root / "world", "train", (p,), ("data",), deadline_s=240,
                        args={"dp": p, "configs": CONFIGS, "steps": STEPS, "batch": 2 * p,
                              "ckpt": ckpt})
    return p, ranks, sim, ckpt


def _rows_of(tag: str) -> tuple:
    mode = tag.split("-")[0]
    if mode == "local_sgd":
        return ("params", "opt")
    return ("monitor",) if mode == "mrd_leaf" else ("opt", "monitor")


def _non_owner_row(tag: str, key: str, p: int, r: int) -> bool:
    return (tag.split("-")[0] in ZERO1 and zero1_owner_segments(p)[r] is None
            and key.split("/")[1] == "opt" and key.split("/")[2] in ("master", "mu", "nu"))


def check_rank(got: dict, sim: dict, prefix: str, tag: str, p: int, r: int,
               skip_non_owner: bool = True) -> None:
    """Rank ``r``'s entries under ``prefix`` against the sim's row r, bit
    for bit; a non-owner's optimizer rows stay zero (module docstring)."""
    rows = _rows_of(tag)

    def under(d):
        return {k for k in d if k.startswith(prefix + "/") and not k.endswith("monitor_msgs")}

    keys = sorted(under(sim))
    assert keys and set(keys) == under(got), prefix
    for k in keys:
        want, have = sim[k], got[k]
        part = k[len(prefix) + 1:].split("/")
        if part[0] == "state" and part[1] in rows:
            want = want[r]
        if _non_owner_row(tag, k[len(prefix) + 1:], p, r):
            if skip_non_owner:
                assert not have.any(), (k, r)
            continue
        assert have.dtype == want.dtype and have.shape == want.shape, (k, r)
        assert torch.equal(have, want), (k, r, float((have.float() - want.float()).abs().max()))


@pytest.mark.parametrize("tag", TAGS)
def test_every_rank_equals_the_sims_row(world, tag):
    p, ranks, sim, _ = world
    for i in range(1, STEPS + 1):
        prefix = f"{tag}/step{i}"
        for r, got in enumerate(ranks):
            check_rank(got, sim, prefix, tag, p, r)
        # the monitor's messages of the step, summed over the world's ranks
        sent = sum(int(got[f"{prefix}/monitor_msgs"]) for got in ranks)
        assert sent == int(sim[f"{prefix}/monitor_msgs"]), (prefix, sent)
        if tag.split("-")[0] != "local_sgd":
            assert sent > 0
    if p == 3 and tag.split("-")[0] != "local_sgd":  # one MRD cycle: certified at step 3
        assert [bool(ranks[0][f"{tag}/step{i}/metrics/converged"]) for i in (1, 2, 3)] == [
            False, False, True]


@pytest.mark.parametrize("world", [3], indirect=True, ids=lambda p: f"p{p}")
@pytest.mark.parametrize("tag", CKPT_TAGS)
def test_world_checkpoints_resume_and_cross_to_the_sim(world, tag):
    p, ranks, sim, ckpt = world
    for r, got in enumerate(ranks):
        for i in range(2, STEPS + 1):
            resumed = {k.replace("/resumed", ""): v for k, v in got.items()
                       if k.startswith(f"{tag}/resumed/step{i}/")}
            assert resumed
            for k, v in resumed.items():
                assert torch.equal(v, got[k]), (r, k)
            # from the sim's step-1 checkpoint: the sim's rows, its non-owner
            # rows included, then this world's step
            check_rank({k.replace("/from_sim", ""): v for k, v in got.items()
                        if k.startswith(f"{tag}/from_sim/")}, sim, f"{tag}/step{i}", tag, p, r,
                       skip_non_owner=False)
    # the world's checkpoint restores in the stacked-rows trainer, which then
    # continues as its uninterrupted run
    cfg = registry.get_smoke_config(W.TRAIN_ARCH)
    mode, opt = tag.split("-")
    step = step_lib.make_train_step(cfg, W.train_tcfg({"mode": mode, "optimizer": opt}), dp=p,
                                    device="cpu")
    template = convert.train_state_to_reference(step.init_state(
        torch.Generator().manual_seed(0)))
    state = convert.train_state_from_reference(
        Checkpointer(ckpt[tag]["world"]).restore(1, template, dp=p), cfg, "cpu")
    pipe = SyntheticPipeline(cfg, DataConfig(batch=2 * p, seq_len=W.TRAIN_SEQ, seed=0), "cpu")
    batches = [pipe.next_batch() for _ in range(STEPS)]
    out = {}
    for i in range(1, STEPS):
        state, m = step(state, batches[i])
        W._record(out, f"{tag}/step{i + 1}", state, m, 0, world=False, replica=False)
    for k, v in out.items():
        if k.endswith("monitor_msgs"):
            continue
        want = sim[k]
        if mode in ZERO1 and k.split("/")[3] == "opt" and k.split("/")[4] != "ef":
            owners = [o is not None for o in zero1_owner_segments(p)]
            v, want = v[owners], want[owners]
        assert torch.equal(v, want), k


def test_resolve_executor_table():
    tcfg = step_lib.TrainConfig()
    mesh = object()  # any world
    assert step_lib.resolve_executor(tcfg, compressed=True) == "sim"
    assert step_lib.resolve_executor(tcfg) == "sim"
    assert step_lib.resolve_executor(tcfg, compressed=True, mesh=mesh, device="cuda") == (
        "device_fused")
    assert step_lib.resolve_executor(tcfg, compressed=True, mesh=mesh, device="cpu") == "device"
    assert step_lib.resolve_executor(tcfg, mesh=mesh, device="cuda") == "device"
    explicit = step_lib.TrainConfig(collective_executor="device")
    for kw in ({}, {"compressed": True, "mesh": mesh, "device": "cuda"}):
        assert step_lib.resolve_executor(explicit, **kw) == "device"


def test_a_world_on_cuda_raises_without_cards(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device(0, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="one card a rank"):
        rank_device(1, "cuda", local_world=4)
    assert rank_device(1, "cuda", local_world=2) == torch.device("cuda", 1)
    assert rank_device(3, "cpu", local_world=4) == torch.device("cpu")


def _torchrun(nproc: int, argv: list, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
         "--standalone", "-m", "repro_torch.launch.train", *argv],
        capture_output=True, text=True, env=env, timeout=240, cwd=tmp_path)


def test_world_cli_equals_the_stacked_cli_and_refuses_another_dp(tmp_path, capsys):
    """The world CLI equals the stacked one; ``--profile`` profiles the last
    step on rank 0 and counts its blocking plan runs: the sim's gradient
    reduce-scatter, grad-norm allreduce and all-gather, and in the world
    also the gathered loss."""
    from repro_torch.launch import train

    argv = ["--arch", "llama3.2-1b", "--smoke", "--steps", "2", "--batch", "6", "--seq", "16",
            "--dp", "3", "--grad-sync", "compressed", "--optimizer", "lion", "--device", "cpu",
            "--profile"]
    proc = _torchrun(3, argv + ["--summary-json", str(tmp_path / "rank{rank}.json")], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(3)]
    sim = train.main(argv)
    for r, rec in enumerate(recs):
        assert (rec["rank"], rec["world_size"]) == (r, 3)
        assert rec["losses"] == sim["losses"] and rec["grad_norms"] == sim["grad_norms"]
        assert np.isfinite(rec["losses"]).all() and rec["peak_bytes"] is None
        assert ("profile" in rec) == (r == 0)
    assert set(recs[0]["profile"]) == {"wall_ms", "plan_runs"}  # no card: no device times
    assert recs[0]["profile"]["plan_runs"] == 4 and sim["profile"]["plan_runs"] == 3
    bad = _torchrun(2, argv, tmp_path)
    assert bad.returncode != 0 and "--dp must equal WORLD_SIZE" in bad.stderr, bad.stderr[-2000:]


def test_world_cli_resumes_from_its_checkpoint(tmp_path):
    """Two world runs through the CLI (2 steps, then 1 more resumed from
    the first's checkpoint) give the stacked trainer's 3 steps."""
    from repro_torch.launch import train

    argv = ["--arch", "llama3.2-1b", "--smoke", "--batch", "6", "--seq", "16", "--dp", "3",
            "--grad-sync", "mrd_zero1", "--schedule", "const", "--device", "cpu"]
    world = argv + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1",
                    "--summary-json", str(tmp_path / "rank{rank}.json")]
    first = _torchrun(3, world + ["--steps", "2"], tmp_path)
    assert first.returncode == 0, first.stderr[-3000:]
    a = json.loads((tmp_path / "rank1.json").read_text())
    second = _torchrun(3, world + ["--steps", "1"], tmp_path)
    assert second.returncode == 0, second.stderr[-3000:]
    b = json.loads((tmp_path / "rank1.json").read_text())
    assert a["resumed_from"] is None and b["resumed_from"] == 2
    sim = train.main(argv + ["--steps", "3"])
    assert a["losses"] + b["losses"] == sim["losses"]
    assert a["grad_norms"] + b["grad_norms"] == sim["grad_norms"]
