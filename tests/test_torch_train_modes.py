"""The ``mrd_leaf`` and ``local_sgd`` grad-sync modes against the
reference's, on the smoke ``llama3.2-1b`` at dp 3 and 5 (the paper's
non-power-of-two cases), 4 steps with ``local_sync_every`` 2, so that
``local_sgd`` averages its replicas twice; and ``local_sgd``'s bounded
staleness (the reference's ``tests/test_local_sgd.py``): the replicas
part between averages and are equal bit for bit after each.  And every
registered arch builds and runs a step under every mode at remat
``none``, ``full`` and ``dots``.

The recording, the teacher-forced steps and the tolerances are
``test_torch_train_families.py``'s (``mrd_leaf``'s replicated AdamW has
its first-step sign flips; each ``local_sgd`` replica has its own), and
the optimizer trees are compared leaf by leaf.

The same recording holds extra runs of 2 teacher-forced steps each: Lion
and SGD under ``mrd_zero1`` and ``mrd_leaf`` at dp 3 (Lion's ties are its
``sign``'s, SGD has none: ``check_exact``); ``compressed`` at dp 2, 3, 4,
5 and 7 (its int8 tie rule); ``microbatches`` 2 and remat ``dots`` under
``mrd_zero1`` at dp 3.

The multi-process trainer is held to the same recording directly: a
gloo world of 3 ranks (``tests/torch_dist_worker.py``) runs the first 2
steps of ``compressed`` and of ``mrd_leaf`` at dp 3, each rank from its
part of the reference's state before the step (its rows of the
``[dp, ...]`` leaves) on its shard of the reference's batch, and each
rank's state after the step is held to its rows of the reference's with
the same tolerances.  A ZeRO-1 rank that owns no segment (rank 2 at
dp 3) runs no optimizer update, so its ``master``/``mu``/``nu`` rows stay
as they were, where the reference updates that row from stale values
that nothing reads.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.collectives import buckets  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402

import torch_dist_worker as W  # noqa: E402
from repro_torch.distributed.gradsync.mrd_zero1 import zero1_owner_segments  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from test_torch_train_families import MODES as SYNC_MONITORS  # noqa: E402
from test_torch_train_families import (  # noqa: E402
    LR,
    check_metrics,
    check_monitor,
    check_state,
    check_train_steps,
    train_tcfg,
)
from torch_train_ref import (  # noqa: E402,F401
    one_thread,
    record_script,
    run_reference,
    torch_batch,
    tree,
)

MODES = ("mrd_leaf", "local_sgd")
DPS = (3, 5)
STEPS, EVERY = 4, 2
ARCH = "llama3.2-1b"
# the recording's extra runs: tag -> (mode, dp, OptimizerConfig fields, TrainConfig fields)
EXTRA = {
    **{f"{name}/{mode}/": (mode, 3, {"name": name}, {})
       for name in ("lion", "sgd") for mode in ("mrd_zero1", "mrd_leaf")},
    **{f"compressed/dp{dp}/": ("compressed", dp, {}, {}) for dp in (2, 3, 4, 5, 7)},
    "microbatches2/": ("mrd_zero1", 3, {}, {"microbatches": 2}),
    "dots/": ("mrd_zero1", 3, {}, {"remat": "dots"}),
}
EXTRA_STEPS = 2


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    extra = [{"tag": tag, "arch": ARCH, "mode": mode, "dp": dp, "steps": EXTRA_STEPS,
              "optimizer": opt, "tcfg": tcfg} for tag, (mode, dp, opt, tcfg) in EXTRA.items()]
    script = record_script({ARCH: list(MODES)}, dps=DPS, steps=STEPS, lr=LR,
                           modes=SYNC_MONITORS, extra=extra, local_sync_every=EVERY)
    devices = max(max(DPS), *(dp for _, dp, _, _ in EXTRA.values()))
    return run_reference(script, tmp_path_factory.mktemp("ref") / "ref.npz", devices=devices)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_reference(reference_run, mode, dp):
    state = check_train_steps(reference_run, "llama3.2-1b", mode, dp=dp, steps=STEPS,
                              local_sync_every=EVERY)
    if mode == "local_sgd":  # step 4 averaged the replicas
        for leaf in buckets.tree_flatten(state["params"])[0]:
            assert all(torch.equal(leaf[0], leaf[r]) for r in range(dp))


@pytest.mark.parametrize("tag", sorted(EXTRA))
def test_extra_run_matches_reference(reference_run, tag):
    mode, dp, opt, tcfg = EXTRA[tag]
    check_train_steps(reference_run, ARCH, mode, dp=dp, steps=EXTRA_STEPS, tag=tag,
                      optimizer=opt, **tcfg)


# the world's runs: recording tag -> (mode, its TrainConfig fields)
WORLD_DP, WORLD_STEPS = 3, 2
WORLD_RUNS = {"compressed/dp3/": ("compressed", {}),
              f"{ARCH}/mrd_leaf/{WORLD_DP}/": ("mrd_leaf", {"local_sync_every": EVERY})}
OPT_ROWS = ("master", "mu", "nu")


def rank_part(state: dict, r: int) -> dict:
    """Rank ``r``'s part of a reference train state: its rows of the
    ``[dp, ...]`` leaves (the optimizer's under ZeRO-1, and the
    monitor's)."""
    parts = ("opt", "monitor") if convert.sync_layout(state) == "zero1" else ("monitor",)

    def row(node):
        return {k: row(v) for k, v in node.items()} if isinstance(node, dict) else node[r]

    return {k: row(v) if k in parts else v for k, v in state.items()}


@pytest.fixture(scope="module")
def forced_world(reference_run, tmp_path_factory):
    """Every rank's state and metrics after each teacher-forced world step
    of :data:`WORLD_RUNS`, and the reference's rank parts before and after
    it: {tag: [(ranks' records, [(before, after) a rank]) a step]}."""
    cfg = registry.get_smoke_config(ARCH)
    runs, parts = {}, {}
    for tag, (mode, kw) in WORLD_RUNS.items():
        steps = []
        for i in range(WORLD_STEPS):
            before = tree(reference_run, tag + ("init/" if i == 0 else f"state{i}/"))
            after = tree(reference_run, f"{tag}state{i + 1}/")
            ranks = [(convert.rank_state_from_reference(rank_part(before, r), cfg, "cpu"),
                      convert.rank_state_from_reference(rank_part(after, r), cfg, "cpu"))
                     for r in range(WORLD_DP)]
            parts.setdefault(tag, []).append(ranks)
            steps.append(([b for b, _ in ranks], torch_batch(tree(reference_run,
                                                                  f"{tag}batch{i}/"))))
        runs[tag] = (train_tcfg(mode, **kw), steps)
    got = W.run_world(tmp_path_factory.mktemp("forced_world"), "train_forced", (WORLD_DP,),
                      ("data",), deadline_s=240, args={"dp": WORLD_DP, "runs": runs})
    return got, parts


@pytest.mark.parametrize("tag", sorted(WORLD_RUNS))
def test_world_ranks_match_the_reference_rows(reference_run, forced_world, tag):
    mode = WORLD_RUNS[tag][0]
    cfg = registry.get_smoke_config(ARCH)
    got, parts = forced_world
    owners = zero1_owner_segments(WORLD_DP)
    for i in range(WORLD_STEPS):
        prefix = f"{tag}step{i + 1}"
        for r, rec in enumerate(got):
            before, after = parts[tag][i][r]
            check_metrics(tree(rec, f"{prefix}/metrics/"), tree(reference_run,
                                                                f"{tag}metrics{i}/"), mode, i)
            state = convert.rank_state_from_reference(tree(rec, f"{prefix}/state/"), cfg, "cpu")
            assert state["step"] == after["step"] == i + 1
            if mode == "compressed" and owners[r] is None:  # no update: its rows as they were
                for k in OPT_ROWS:
                    assert torch.equal(state["opt"][k], before["opt"][k]), (prefix, r, k)
                after = {**after, "opt": {**after["opt"], **{k: before["opt"][k]
                                                             for k in OPT_ROWS}}}
            check_state(state, after, f"{prefix} rank {r}", mode == "compressed",
                        before=before)
            check_monitor(state, after)


def test_local_sgd_replicas_part_between_averages_and_meet_at_them():
    cfg = registry.get_smoke_config("llama3.2-1b")
    tcfg = step_lib.TrainConfig(remat="none", grad_sync="local_sgd", monitor=False,
                                local_sync_every=3, bucket_bytes=1 << 12,
                                optimizer=OptimizerConfig(lr=5e-3, schedule="const",
                                                          warmup_steps=0))
    step = step_lib.make_train_step(cfg, tcfg, dp=4, device="cpu")
    state = step.init_state(torch.Generator().manual_seed(0))
    pipe = SyntheticPipeline(cfg, DataConfig(batch=8, seq_len=16, seed=0), "cpu")
    for i in range(6):
        state, m = step(state, pipe.next_batch())
        w = state["params"]["embed"]
        spread = float((w - w[0]).abs().max())
        if (i + 1) % 3 == 0:
            assert spread == 0.0, (i, spread)
            for leaf in buckets.tree_flatten(state["opt"]["master"])[0]:  # not averaged
                assert not torch.equal(leaf[0], leaf[1])
        else:
            assert spread > 0, i
        assert not bool(m["converged"]) and float(m["monitor_value"]) == 0.0


@pytest.mark.parametrize("mode", ["mrd_paper", "mrd_zero1", "compressed", "mrd_leaf",
                                  "local_sgd"])
def test_every_arch_trains_under_every_mode(mode):
    for arch in registry.list_archs():
        cfg = registry.get_smoke_config(arch)
        for remat in ("none", "full", "dots"):
            tcfg = step_lib.TrainConfig(remat=remat, grad_sync=mode, monitor=True,
                                        monitor_threshold=6.0, local_sync_every=1,
                                        bucket_bytes=1 << 14)
            step = step_lib.make_train_step(cfg, tcfg, dp=3, device="cpu")
            state = step.init_state(torch.Generator().manual_seed(1))
            batch = SyntheticPipeline(cfg, DataConfig(batch=3, seq_len=8), "cpu").next_batch()
            state, m = step(state, batch)
            assert state["step"] == 1
            assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])), (
                arch, mode, remat)
