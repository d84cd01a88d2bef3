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

The same file checks that an elastic ``gspmd`` world and a resize of a
mesh with a ``"model"`` dimension are refused with the ROADMAP item that
will port them, and that ``scripts/elastic_cards.*`` import neither
``jax`` nor the reference package.
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
from repro_torch.distributed import gradsync  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.runtime import ElasticTrainer, shrink_mesh  # noqa: E402
from test_torch_hygiene import FORBIDDEN, _imported_roots, _shell_python  # noqa: E402
from torch_chaos import KILL_JOIN_TRAJECTORY  # noqa: E402

MODES = ("mrd_zero1", "compressed", "mrd_paper", "mrd_leaf", "local_sgd")
WORLD = 5  # the initial ranks 0-3 and the spare 4
ARGV = ["--smoke", "--device", "cpu", "--steps", "10", "--batch", "60", "--seq", "8",
        "--bucket-bytes", str(1 << 16), "--kill", "2:2", "--kill", "7:1", "--join", "4:2,4"]


def _args(mode):
    return EC.build_parser().parse_args(ARGV + ["--mode", mode])


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
            torch.save(out, out_dir / f"rank{rank}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


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


def test_gspmd_worlds_and_tp_meshes_are_refused():
    cfg = registry.get_smoke_config("llama3.2-1b")

    class _Mesh:  # what the refusals read of a DeviceMesh
        def __init__(self, names):
            self.mesh_dim_names = names
            self.mesh = torch.arange(4).reshape((2, 2) if len(names) == 2 else (4,))

    gspmd = step_lib.TrainConfig(grad_sync="gspmd")
    with pytest.raises(NotImplementedError, match="item 7b2"):
        ElasticTrainer(_Mesh(("data",)), (cfg, gspmd), lambda m: None, device="cpu")
    zero1 = step_lib.TrainConfig(grad_sync="mrd_zero1")
    with pytest.raises(NotImplementedError, match="item 7b2"):
        ElasticTrainer(_Mesh(("data", "model")), (cfg, zero1), lambda m: None, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7b2"):
        shrink_mesh(_Mesh(("data", "model")), {1})
    with pytest.raises(NotImplementedError, match="item 7b2"):
        gradsync.migrate_state(cfg, gspmd, _Mesh(("data",)), _Mesh(("data",)), {}, (0, 1, 2))
    with pytest.raises(ValueError, match="no checkpointer"):
        ElasticTrainer(_Mesh(("data",)), (cfg, zero1), lambda m: None, checkpointer=object(),
                       device="cpu")


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
