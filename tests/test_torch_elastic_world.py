"""The elastic trainer in a ``("data",)`` world of one process a rank
(gloo on the CPU) against the stacked-rows elastic trainer.

One world of 5 processes runs the reference chaos suite's headline script
(``Kill(2, 2)``, ``Join(4, (2, 4))``, ``Kill(7, 1)``: 4 -> 3 -> 5 -> 4,
the killed rank 2 joining again with the spare 4) on the smoke
``llama3.2-1b`` under ``mrd_zero1``, ``compressed``, ``mrd_paper``,
``mrd_leaf`` and ``local_sgd`` (a joiner's replica and optimizer trees
sent from new rank 0, the first survivor), through
``scripts/elastic_cards.py``'s ``run`` (the program of the four-card run).
Every process runs the same controller on the same clock and script, so
all reach the same decisions; a process outside the mesh skips the step.
The parent runs the stacked-rows trainer on the same script at one
intra-op thread, as the ranks run.  Every loss a rank records (the ranks'
mean, gathered exactly) equals the stacked run's, the trajectory too, and
every live rank's final state equals the stacked trainer's row bit for
bit: the params (a replica under ``local_sgd``), the optimizer (the EF
residual, and the master/moment rows of a rank that owns a ZeRO-1
segment: a non-owner's are not updated in a world, where the stacked
rows update them from stale values nothing reads) and the monitor's
value and latch.

The same world checks that an elastic ``gspmd`` world with a checkpointer
and a resize of a mesh with a ``"model"`` dimension now run, and what is
still refused; the file also checks that ``scripts/elastic_cards.*``
import neither ``jax`` nor the reference package.
"""

import datetime
import multiprocessing
import sys
import traceback
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import elastic_cards as EC  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.runtime import ElasticTrainer, ResizeDecision  # noqa: E402
from test_torch_hygiene import FORBIDDEN, _imported_roots, _shell_python  # noqa: E402
from torch_chaos import KILL_JOIN_TRAJECTORY  # noqa: E402

MODES = ("mrd_zero1", "compressed", "mrd_paper", "mrd_leaf", "local_sgd")
WORLD = 5  # the initial ranks 0-3 and the spare 4
ARGV = ["--smoke", "--device", "cpu", "--steps", "10", "--batch", "60", "--seq", "8",
        "--bucket-bytes", str(1 << 16), "--kill", "2:2", "--kill", "7:1", "--join", "4:2,4"]


def _args(mode):
    return EC.build_parser().parse_args(ARGV + ["--grad-sync", mode])


def _rank(rank, store, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.gradsync import common

    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=WORLD, timeout=datetime.timedelta(seconds=60))
        try:
            out = {}
            for mode in MODES:
                mesh = DeviceMesh("cpu", [0, 1, 2, 3], mesh_dim_names=("data",))
                tr, state, rec = EC.run(_args(mode), mesh, torch.device("cpu"))
                view = None
                if tr.member():
                    view = EC.rank_view(state, mode, common.mesh_rank(tr.mesh), tr.dp(), False)
                out[mode] = {"rec": rec, "view": view, "ids": list(tr.device_ids())}
            out["accepted"] = _accepted(rank)
            torch.save(out, out_dir / f"rank{rank}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _accepted(rank) -> dict:
    """What an elastic world accepts now (run on every process of the
    world of 5): a ``gspmd`` trainer on a ``("data",)`` mesh of ranks 0-3
    with a checkpointer, shrunk by a failure, then a ``mrd_zero1`` trainer
    on a ``("data", "model")`` mesh ``[[0, 1], [2, 3]]`` whose failure of
    rank 1 drops its slice, and the ``gspmd`` hook on a ``(data,)`` world
    of 4 -> 3; and what it still refuses: an opaque step factory, a joiner
    count short of a slice (``grow_mesh`` raises, the trainer keeps it
    pending), a checkpoint of another ``tp``."""
    import tempfile

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed.gradsync import common
    from repro_torch.runtime import ElasticConfig, grow_mesh

    cfg = registry.get_smoke_config("llama3.2-1b")
    dcfg = DataConfig(batch=12, seq_len=8, seed=0)

    def pipe(m):
        return SyntheticPipeline(cfg, dcfg, "cpu", rank=common.mesh_rank(m), dp=common.mesh_dp(m))

    out: dict = {}
    ck_dir = tempfile.mkdtemp() if rank == 0 else None
    ck_dir = _broadcast_str(ck_dir)
    gspmd = step_lib.TrainConfig(grad_sync="gspmd", remat="none")
    data = DeviceMesh("cpu", [0, 1, 2, 3], mesh_dim_names=("data",))
    tr = ElasticTrainer(data, (cfg, gspmd), pipe, device="cpu",
                        checkpointer=Checkpointer(ck_dir, world=(rank, WORLD)),
                        cfg=ElasticConfig(policy="grow_on_join", ckpt_every=1))
    state, losses = tr.run(tr.init_or_restore(torch.Generator().manual_seed(0)), 1)
    state = tr.handle_failure(state, {2})
    out["gspmd"] = {"losses": losses, "ids": tr.device_ids(), "member": tr.member(),
                    "saved": tr.ck.latest_step()}
    zero1 = step_lib.TrainConfig(grad_sync="mrd_zero1", remat="none")
    grid = DeviceMesh("cpu", torch.tensor([[0, 1], [2, 3]]), mesh_dim_names=("data", "model"))
    tr = ElasticTrainer(grid, (cfg, zero1), pipe, device="cpu",
                        cfg=ElasticConfig(policy="grow_on_join"))
    state = tr.handle_failure(tr.init_or_restore(torch.Generator().manual_seed(0)), {1})
    out["tp"] = {"ids": tr.device_ids(), "keep": tr.resizes[-1].keep, "dp": tr.dp(),
                 "tp": tr.tp()}
    refusals = []
    try:
        ElasticTrainer(data, lambda m: None, pipe, device="cpu")
    except ValueError as e:
        refusals.append(str(e))
    try:
        grow_mesh(tr.mesh, [4])
    except ValueError as e:
        refusals.append(str(e))
    pending = tr._clamp_grow(ResizeDecision("grow", admit=(4,)))
    out["pending_kept"] = pending.action
    if tr.member():
        ck = Checkpointer(ck_dir)
        ck.bind_world(None)
        tr.ck = ck
        try:
            tr.init_or_restore(torch.Generator().manual_seed(0))
        except ValueError as e:
            refusals.append(str(e))
        tr.ck = None
    out["refusals"] = refusals
    return out


def _broadcast_str(value):
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_world")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(root / "store"), str(root)), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: the same sums, bit for bit
    try:
        stacked = {}
        for mode in MODES:
            tr, state, rec = EC.run(_args(mode))
            stacked[mode] = (tr, state, rec)
    finally:
        torch.set_num_threads(n)
    for p in procs:
        p.join(240)
    errs = {r: (root / f"rank{r}.err").read_text() for r in range(WORLD)
            if (root / f"rank{r}.err").exists()}
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not errs and all(p.exitcode == 0 for p in procs), errs
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], stacked


def _equal(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}/{k}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), (what, float((a.double() - b.double()).abs().max()))


@pytest.mark.parametrize("mode", MODES)
def test_every_live_rank_equals_the_stacked_row(world, mode):
    ranks, stacked = world
    tr, state, rec = stacked[mode]
    traj = [(k, o, n) for k, o, n, _ in rec["trajectory"]]
    assert traj == KILL_JOIN_TRAJECTORY and [s for *_, s in rec["trajectory"]] == [2, 4, 7]
    ids = list(tr.device_ids())
    assert ids == [0, 3, 2, 4]
    live = 0
    for r, out in enumerate(ranks):
        got = out[mode]
        assert got["rec"]["trajectory"] == rec["trajectory"] and got["ids"] == ids, r
        losses = got["rec"]["losses"]
        assert len(losses) == len(rec["losses"]) == 10
        # the steps each rank sat out: rank 2 after its kill until it
        # joined again, rank 4 until it joined, rank 1 after its kill
        sat_out = {1: {7, 8, 9}, 2: {2, 3}, 4: {0, 1, 2, 3}}.get(r, set())
        assert {i for i, x in enumerate(losses) if x is None} == sat_out, r
        assert all(x is None or x == y for x, y in zip(losses, rec["losses"])), (r, losses)
        if r not in ids:
            assert got["view"] is None
            continue
        live += 1
        pos = ids.index(r)
        want = EC.rank_view(state, mode, pos, tr.dp(), True)
        _equal(got["view"], want, f"{mode} rank {r}")
    assert live == 4


def test_gspmd_worlds_and_tp_meshes_are_refused(world):
    """No longer refused: an elastic ``gspmd`` world with a checkpointer
    trains, saves and shrinks (4 -> 3), and a ``("data", "model")`` world
    shrinks by whole slices (rank 1's failure drops slice 0).  Still
    refused: an elastic world of an opaque step factory, a joiner count
    short of a slice (kept pending by the trainer), a restore onto another
    ``tp``."""
    ranks, _ = world
    for r, out in enumerate(ranks):
        got = out["accepted"]
        g = got["gspmd"]
        assert g["ids"] == (0, 1, 3) and g["member"] == (r in (0, 1, 3)), r
        if r < 4:
            assert len(g["losses"]) == 1 and g["losses"][0] is not None and g["saved"] == 1, r
        assert got["tp"] == {"ids": (2, 3), "keep": (1,), "dp": 1, "tp": 2}, r
        assert got["pending_kept"] == "none", r
        refusals = got["refusals"]
        assert "migrates in place" in refusals[0], r
        assert "multiple of 2 joining devices" in refusals[1], r
        if r in (2, 3):  # the (1, 2) mesh's members: a checkpoint saved at tp=1
            assert "saved at tp=1, this run has tp=2" in refusals[2], r
        else:
            assert len(refusals) == 2, r


@pytest.mark.parametrize("name", ["elastic_cards.sh", "elastic_cards.py"])
def test_the_elastic_card_scripts_import_neither_jax_nor_the_reference(name, tmp_path):
    path = ROOT / "scripts" / name
    programs = [path.read_text()] if name.endswith(".py") else _shell_python(path)
    assert path.exists()
    for i, text in enumerate(programs):
        f = tmp_path / f"{i}.py"
        f.write_text(text)
        bad = [(ln, mod) for ln, mod in _imported_roots(f) if mod in FORBIDDEN]
        assert not bad, f"{name} program {i} imports {bad}"
