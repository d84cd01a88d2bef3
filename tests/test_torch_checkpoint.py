"""The port's checkpointer (``repro_torch.checkpoint``), mirroring the
reference's ``tests/test_checkpoint_async.py`` and
``tests/test_checkpoint_migration.py``: stale ``.tmp`` directories swept
and invisible, ``save(block=False)`` and ``block="transfer"`` returning
before the write, bitwise round trips (bf16 leaves included, as uint16 bit
patterns), a writer error surfacing on ``wait``, the step, time and
either-fires policies under a fake clock, retention, the v1 -> v2
migration and the refusal of a newer layout or another dp.  Then the two
packages' checkpoints against each other: a checkpoint the reference
wrote after 2 ``compressed`` steps restores into the port, whose next step
matches the reference's next step (``test_torch_train_families.py``'s
one-step tolerances), and the port writes the reference's keys, shapes
and types; and the train CLI's resume: a run restored from step 2 repeats
the uninterrupted run's last 2 steps bit for bit on the CPU.
"""

import os
import shutil
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpointer as ckpt_lib  # noqa: E402
from repro_torch.checkpoint import Checkpointer, migrate_layout  # noqa: E402
from repro_torch.collectives import buckets  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402

from test_torch_train_families import LR, MODES, check_state  # noqa: E402
from torch_train_ref import one_thread, run_reference, torch_batch, tree  # noqa: E402,F401


def _state(seed=0, n=64):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((n, n), generator=g),
                       "b": torch.randn((n,), generator=g).to(torch.bfloat16)},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _equal(a, b):
    fa, fb = ckpt_lib.flatten_with_paths(a), ckpt_lib.flatten_with_paths(b)
    assert sorted(fa) == sorted(fb)
    return all(fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


def test_stale_tmp_swept_on_construction(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_7.tmp"))
    with open(os.path.join(d, "step_7.tmp", "arrays.npz"), "wb") as f:
        f.write(b"torn")
    with open(os.path.join(d, "LATEST.tmp"), "w") as f:
        f.write("7")
    ck = Checkpointer(d)
    assert not os.path.exists(os.path.join(d, "step_7.tmp"))
    assert not os.path.exists(os.path.join(d, "LATEST.tmp"))
    assert ck.list_steps() == [] and ck.latest_step() is None


def test_tmp_dirs_invisible_to_listing(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _state(3), block=True)
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))
    assert ck.list_steps() == [3] and ck.latest_step() == 3
    ck2 = Checkpointer(str(tmp_path))
    assert not os.path.exists(os.path.join(str(tmp_path), "step_9.tmp"))
    assert _equal(ck2.restore(3, _state(0)), _state(3))


def _gated_savez(monkeypatch):
    gate, entered = threading.Event(), threading.Event()
    real = np.savez

    def slow(path, **arrays):
        entered.set()
        assert gate.wait(timeout=30), "writer never released"
        real(path, **arrays)

    monkeypatch.setattr(ckpt_lib.np, "savez", slow)
    return gate, entered


@pytest.mark.parametrize("block", [False, "transfer"])
def test_async_and_transfer_saves_return_before_the_write(tmp_path, monkeypatch, block):
    gate, entered = _gated_savez(monkeypatch)
    ck = Checkpointer(str(tmp_path))
    state = _state(1)
    ck.save(1, state, block=block)  # returns with the writer gated
    assert entered.wait(timeout=30)
    assert ck.list_steps() == []  # nothing published yet
    state["params"]["w"].add_(1.0)  # the next step's in-place update
    gate.set()
    ck.wait()
    assert ck.list_steps() == [1] and ck.latest_step() == 1
    assert _equal(ck.restore(1, _state(0)), _state(1))  # the staged copy was written
    rec = ck.saves[0]
    assert rec["step"] == 1 and rec["hold_s"] >= 0 and rec["write_s"] > 0
    assert rec["bytes"] == 64 * 64 * 4 + 64 * 2 + 4


def test_round_trips_are_bitwise_bf16_included(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state(5)
    ck.save(5, state, extra={"data": {"step": 17, "seed": 0}}, block=True)
    got = ck.restore(5, _state(0))
    assert _equal(got, state) and got["params"]["b"].dtype == torch.bfloat16
    m = ck.manifest(5)
    assert m["extra"]["data"]["step"] == 17 and m["layout_version"] == ckpt_lib.LAYOUT_VERSION
    assert m["bf16"] == ["params/b"] and m["n_arrays"] == 3
    with np.load(os.path.join(str(tmp_path), "step_5", "arrays.npz")) as z:
        assert z["params/b"].dtype == np.uint16  # the bit patterns


def test_saves_reuse_their_host_buffers(tmp_path):
    """A second save of the same shapes stages into the first save's host
    buffers (allocated once) and still writes its own values; a leaf of
    another shape gets a buffer of its own."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1), block=False)
    first = {k: t.data_ptr() for k, t in ck._staging.items()}
    ck.save(2, _state(2), block=False)
    assert {k: t.data_ptr() for k, t in ck._staging.items()} == first
    assert ck.saves[1]["wait_s"] >= 0 and ck.saves[1]["hold_s"] >= 0
    ck.save(3, _state(3, n=32), block=True)
    assert ck._staging["params/w"].data_ptr() != first["params/w"]
    for step, n in ((1, 64), (2, 64), (3, 32)):
        assert _equal(ck.restore(step, _state(0, n=n)), _state(step, n=n))


def test_writer_error_surfaces_on_wait(tmp_path, monkeypatch):
    def boom(path, **arrays):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_lib.np, "savez", boom)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1), block=False)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.list_steps() == []
    ck.wait()  # raised once, then clear


def test_save_policies_with_a_fake_clock(tmp_path):
    now = [100.0]
    steps = Checkpointer(str(tmp_path / "s"), save_every_steps=3, clock=lambda: now[0])
    assert [steps.should_save(s) for s in range(1, 7)] == [False, False, True] * 2
    timed = Checkpointer(str(tmp_path / "t"), save_every_seconds=10.0, clock=lambda: now[0])
    assert not timed.should_save(1)  # the clock starts at construction
    now[0] = 110.0
    assert timed.should_save(2)
    assert timed.maybe_save(2, _state(2), block=True)
    assert not timed.should_save(3)  # a save restarts it
    both = Checkpointer(str(tmp_path / "b"), save_every_steps=4, save_every_seconds=5.0,
                        clock=lambda: now[0])
    assert both.should_save(4) and not both.should_save(5)
    now[0] = 116.0
    assert both.should_save(5)
    assert not Checkpointer(str(tmp_path / "n"), clock=lambda: now[0]).maybe_save(1, _state())


def test_gc_keeps_the_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s), block=False)
    ck.wait()
    assert ck.list_steps() == [3, 4] and ck.latest_step() == 4
    with open(os.path.join(str(tmp_path), "LATEST"), "w") as f:
        f.write("1")  # a pointer at a collected step falls back to the newest
    assert ck.latest_step() == 4


def _monitor_state(dp=3):
    return {"opt": {"master": torch.ones(dp, 8), "ef": torch.zeros(dp, 8)},
            "monitor": {"m": {"latched": torch.full((dp,), 2.0)}, "value": torch.zeros(dp)}}


def test_v1_checkpoint_migrates_both_breaks(tmp_path):
    """Layout 1: no ``opt/ef`` (a zero residual is what a run that never
    compensated holds) and the monitor's policy state outside ``m/``."""
    d = tmp_path / "step_1"
    d.mkdir()
    np.savez(d / "arrays.npz", **{"opt/master": np.full((3, 8), 3.0, np.float32),
                                  "monitor/latched": np.full((3,), 7.0, np.float32),
                                  "monitor/value": np.ones(3, np.float32)})
    got = Checkpointer(str(tmp_path)).restore(1, _monitor_state())
    assert torch.equal(got["opt"]["ef"], torch.zeros(3, 8))
    assert torch.equal(got["monitor"]["m"]["latched"], torch.full((3,), 7.0))
    assert torch.equal(got["opt"]["master"], torch.full((3, 8), 3.0))


def test_future_layouts_and_other_widths_are_refused(tmp_path):
    with pytest.raises(ValueError, match="newer than this code"):
        migrate_layout({}, _monitor_state(), ckpt_lib.LAYOUT_VERSION + 1)
    with pytest.raises(ValueError, match="missing 1 leaves"):
        migrate_layout({"opt/master": np.ones((3, 8), np.float32)},
                       {"opt": {"master": torch.ones(3, 8), "mu": torch.ones(3, 8)}}, 1)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _monitor_state(3), extra={"dp": 3}, block=True)
    with pytest.raises(ValueError, match="item 7"):
        ck.restore(1, _monitor_state(4), dp=4)
    with pytest.raises(ValueError, match="item 7"):  # no dp given: the shapes tell
        ck.restore(1, _monitor_state(4))


@pytest.mark.parametrize("mode", ["compressed", "mrd_leaf", "local_sgd"])
def test_train_state_round_trips_through_the_reference_layout(tmp_path, mode):
    cfg = registry.get_smoke_config("hubert-xlarge")
    tcfg = step_lib.TrainConfig(grad_sync=mode, monitor=mode != "local_sgd",
                                monitor_threshold=1.0)
    step = step_lib.make_train_step(cfg, tcfg, dp=3, device="cpu")
    state = step.init_state(torch.Generator().manual_seed(0))
    ref = convert.train_state_to_reference(state)
    assert convert.sync_layout(ref) == {"compressed": "zero1", "mrd_leaf": "leaf",
                                        "local_sgd": "local"}[mode]
    ck = Checkpointer(str(tmp_path))
    ck.save(0, ref, block=True)
    back = convert.train_state_from_reference(ck.restore(0, ref), cfg, "cpu")
    a, b = buckets.tree_flatten(state), buckets.tree_flatten(back)
    assert a[1] == b[1]
    for x, y in zip(a[0], b[0]):
        assert (x == y) if not isinstance(x, torch.Tensor) else torch.equal(x, y)


_REF_CKPT = textwrap.dedent(
    """
    import sys
    import jax, numpy as np
    from jax.sharding import NamedSharding
    from repro import compat
    from repro.checkpoint.checkpointer import Checkpointer
    from repro.configs import registry
    from repro.data.pipeline import DataConfig, SyntheticPipeline
    from repro.distributed import step as step_lib
    from repro.optim.optimizer import OptimizerConfig

    out, ckdir = {}, sys.argv[1] + ".ckpt"

    def save(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[prefix + key] = np.asarray(jax.device_get(leaf))

    cfg = registry.get_smoke_config("llama3.2-1b")
    mesh = compat.make_mesh((3,), ("data",), devices=jax.devices()[:3],
                            axis_types=compat.default_axis_types(1))
    tcfg = step_lib.TrainConfig(
        microbatches=1, remat="none", grad_sync="compressed", monitor=True,
        monitor_mode="inexact", monitor_threshold=6.0, bucket_bytes=1 << 15,
        optimizer=OptimizerConfig(lr=LR, schedule="const", warmup_steps=0, grad_clip=1.0))
    train_step, init_state, state_specs, _ = step_lib.make_train_step(cfg, mesh, tcfg)
    with mesh:
        state = init_state(jax.random.PRNGKey(0))
        state = jax.device_put(state, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                                   state_specs(state)))
        pipe = SyntheticPipeline(cfg, DataConfig(batch=6, seq_len=16, seed=0), mesh)
        jstep = jax.jit(train_step)
        ck = Checkpointer(ckdir)
        for i in range(3):
            b = pipe.next_batch()
            if i == 2:
                save("batch/", b)
            state, metrics = jstep(state, b)
            if i == 1:
                ck.save(2, state, extra={"data": pipe.state_dict()}, block=True)
        save("metrics/", metrics)
        save("final/", state)
    np.savez(sys.argv[1], **out)
    """
)


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    path = tmp_path / "ref.npz"
    z = run_reference(f"LR = {LR}\n" + _REF_CKPT, path, devices=3)
    cfg = registry.get_smoke_config("llama3.2-1b")
    tcfg = step_lib.TrainConfig(
        microbatches=1, remat="none", grad_sync="compressed", monitor=True,
        monitor_mode=MODES["compressed"], monitor_threshold=6.0, bucket_bytes=1 << 15,
        optimizer=OptimizerConfig(lr=LR, schedule="const", warmup_steps=0, grad_clip=1.0))
    step = step_lib.make_train_step(cfg, tcfg, dp=3, device="cpu")
    ck = Checkpointer(str(path) + ".ckpt")
    assert ck.latest_step() == 2 and ck.manifest(2)["extra"]["data"] == {"step": 2, "seed": 0}
    template = convert.train_state_to_reference(step.init_state(torch.Generator()))
    state = convert.train_state_from_reference(ck.restore(2, template, "cpu", dp=3), cfg, "cpu")
    assert state["step"] == 2
    state, m = step(state, torch_batch(tree(z, "batch/")))
    rm = tree(z, "metrics/")
    assert abs(float(m["loss"]) - float(rm["loss"])) <= 1e-5
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=5e-4)
    assert bool(m["converged"]) == bool(rm["converged"])
    check_state(state, convert.train_state_from_reference(tree(z, "final/"), cfg, "cpu"),
                "step 3", compressed=True)
    # the port writes the reference's keys, shapes and types
    ours = Checkpointer(str(tmp_path / "ours"))
    ours.save(3, convert.train_state_to_reference(state), block=True)
    with np.load(os.path.join(ck.dir, "step_2", "arrays.npz")) as a, \
            np.load(os.path.join(ours.dir, "step_3", "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


def test_cli_trains_and_resumes(tmp_path, capsys):
    base = ["--arch", "gemma3-12b", "--smoke", "--batch", "6", "--seq", "16", "--dp", "3",
            "--grad-sync", "compressed", "--device", "cpu", "--remat", "dots",
            "--monitor-threshold", "0.5", "--schedule", "const"]  # --steps sets a cosine's length
    a = train.main(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a"),
                           "--ckpt-every", "2"])
    assert [r["step"] for r in a["ckpt_saves"]] == [2, 4, 4] and a["resumed_from"] is None
    assert Checkpointer(str(tmp_path / "a")).list_steps() == [2, 4]
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_2", tmp_path / "b" / "step_2")
    (tmp_path / "b" / "LATEST").write_text("2")
    b = train.main(base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    assert b["resumed_from"] == 2 and b["state"]["step"] == 4
    assert b["losses"] == a["losses"][2:] and b["grad_norms"] == a["grad_norms"][2:]
    fa, fb = buckets.tree_flatten(a["state"]), buckets.tree_flatten(b["state"])
    assert fa[1] == fb[1]
    for x, y in zip(fa[0], fb[0]):
        assert (x == y) if not isinstance(x, torch.Tensor) else torch.equal(x, y)
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    with pytest.raises(ValueError, match="item 7"):  # another dp
        train.main(base[:7] + ["--dp", "2"] + base[9:] + [
            "--steps", "1", "--ckpt-dir", str(tmp_path / "b")])
