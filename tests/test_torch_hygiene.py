"""Rules the port keeps: no reference imports, no silent CPU fallback.

- No file of ``src/repro_torch/``, nor ``chip_smoke.py``, nor
  ``scripts/tp_tick_profile.py``, ``scripts/tp_widen_ab.py`` or a Python
  program of ``scripts/tp_cards.sh``, imports ``jax`` or the reference package
  ``repro`` (``repro_torch`` itself is fine).
- Entry points (the serving CLI and workloads, fixed-point serving
  included, the training CLI, the asynchronous engine, its benchmarks and
  example) default to ``device="cuda"`` and raise when torch sees no card,
  instead of running on the CPU.
"""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve_device  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    assert path.exists(), path
    bad = [(ln, mod) for ln, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _shell_python(path: Path) -> list:
    """The Python programs a shell script feeds ``python -`` (its quoted
    ``<<'EOF'`` here-documents)."""
    out, lines, body = [], path.read_text().splitlines(), None
    for line in lines:
        if body is not None:
            if line == "EOF":
                out.append("\n".join(body))
                body = None
            else:
                body.append(line)
        elif "<<'EOF'" in line:
            body = []
    return out


@pytest.mark.parametrize("name", ["tp_cards.sh", "tp_tick_profile.py", "tp_widen_ab.py",
                                  "mrd_tp_cards.sh"])
def test_the_four_card_scripts_import_neither_jax_nor_the_reference(name, tmp_path):
    path = ROOT / "scripts" / name
    programs = [path.read_text()] if name.endswith(".py") else _shell_python(path)
    assert programs
    for i, text in enumerate(programs):
        f = tmp_path / f"{i}.py"
        f.write_text(text)
        bad = [(ln, mod) for ln, mod in _imported_roots(f) if mod in FORBIDDEN]
        assert not bad, f"{name} program {i} imports {bad}"


def test_the_import_scan_sees_forbidden_imports(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import os\nfrom repro.models import transformer\nimport jax.numpy as jnp\n"
                 "from repro_torch import device\n")
    assert [m for _, m in _imported_roots(f) if m in FORBIDDEN] == ["repro", "jax"]


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.serving import make_workload

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--continuous", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_workload("llm_decode_paged", cfg=registry.get_smoke_config("llama3.2-1b"))
    assert resolve_device("cpu") == torch.device("cpu")
    # the contiguous pool and the whole-prompt prefill (gemma3's path)
    from repro_torch.distributed import serve as dserve

    gemma = registry.get_smoke_config("gemma3-12b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma3-12b", "--smoke", "--continuous", "--workload",
                    "llm_decode", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_workload("llm_decode", cfg=gemma)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dserve.make_prefill_step(gemma)
    # falcon-mamba (the mamba1 state in the contiguous pool)
    falcon = registry.get_smoke_config("falcon-mamba-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--continuous", "--workload",
                    "llm_decode", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_workload("llm_decode", cfg=falcon)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dserve.make_prefill_step(falcon)


def test_fixedpoint_entry_points_raise_without_a_card():
    """The fixed-point CLI (no --arch) and its workload."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.launch import serve
    from repro_torch.serving import make_workload

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--continuous", "--workload", "fixedpoint_solve", "--solver",
                    "d_iteration", "--n", "60", "--dp", "3", "--requests", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_workload("fixedpoint_solve", solver="d_iteration", n=60, dp=3)


def test_fixedpoint_cli_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    s = serve.main(["--continuous", "--workload", "fixedpoint_solve", "--solver",
                    "d_iteration", "--n", "60", "--dp", "3", "--requests", "4",
                    "--device", "cpu"]).summary()
    assert s["completed"] == 4 and s["converged"] == 4
    out = capsys.readouterr().out
    assert "fixedpoint_solve[d_iteration] x fcfs x residual_interval (dp=3, n=60, cpu)" in out
    assert "converged 4/4" in out


def test_async_entry_points_raise_without_a_card():
    """The asynchronous engine, its two benchmarks and its example."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch import asynchrony
    from repro_torch.benchmarks import bench_async, bench_detection
    from repro_torch.examples import solve_poisson_async

    fp = asynchrony.make_solver("poisson1d", n=24, shift=0.5)
    cfg = asynchrony.AsyncConfig(p=3, eps=1e-5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asynchrony.run(fp, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asynchrony.sweep(fp, cfg, [0, 1])
    for main in (bench_async.main, bench_detection.main, solve_poisson_async.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


def test_bench_async_runs_on_cpu_when_asked(tmp_path, capsys):
    """``bench_async --quick --check --device cpu``: the oracle baseline and
    the four protocols under two delay models, with the soundness check."""
    from repro_torch.benchmarks import bench_async

    out = tmp_path / "bench_async.json"
    rows = bench_async.main(["--quick", "--check", "--device", "cpu", "--json", str(out)])
    assert len(rows) == 10 and out.exists()
    assert all(not r.get("undetected") for r in rows)
    assert "sanity OK" in capsys.readouterr().out


def test_async_example_runs_on_cpu_when_asked(capsys):
    from repro_torch.examples import solve_poisson_async

    sw = solve_poisson_async.main(["--device", "cpu"])
    assert sw.detected.all() and (sw.true_res < 1e-5).all()
    assert "sweep(): 3 activity levels x 8 seeds" in capsys.readouterr().out


def test_cli_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    s = serve.main(["--arch", "llama3.2-1b", "--smoke", "--continuous", "--dp", "3",
                    "--slots", "2", "--requests", "3", "--prompt-len", "6", "--gen", "5",
                    "--device", "cpu"]).summary()
    assert s["completed"] == 3 and s["tokens_out"] > 0
    assert "llm_decode_paged[kernel]" in capsys.readouterr().out


def test_gemma3_cli_runs_on_cpu_when_asked(capsys):
    """The contiguous workload serves gemma3's rolling local windows; the
    prompts are longer than the smoke config's 16-token window."""
    from repro_torch.launch import serve

    s = serve.main(["--arch", "gemma3-12b", "--smoke", "--continuous", "--workload",
                    "llm_decode", "--dp", "3", "--slots", "2", "--requests", "3",
                    "--min-prompt-len", "17", "--prompt-len", "24", "--gen", "8",
                    "--device", "cpu"]).summary()
    assert s["completed"] == 3 and s["tokens_out"] > 0 and s["forced_at_capacity"] == 0
    assert "llm_decode x fcfs" in capsys.readouterr().out


def test_falcon_cli_runs_on_cpu_when_asked(capsys):
    """The contiguous workload serves falcon-mamba's recurrent state; the
    CPU runs the selective scan's plain version, no kernel."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.launch import serve

    n0 = ss_ops.selective_scan.launches
    s = serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--continuous", "--workload",
                    "llm_decode", "--dp", "3", "--slots", "2", "--requests", "3",
                    "--prompt-len", "12", "--gen", "8", "--device", "cpu"]).summary()
    assert s["completed"] == 3 and s["tokens_out"] > 0 and s["forced_at_capacity"] == 0
    assert ss_ops.selective_scan.launches == n0
    assert "falcon-mamba-7b smoke, cpu" in capsys.readouterr().out


def test_the_import_scan_covers_the_async_engine():
    """The engine's modules, benchmarks and example are scanned like every
    other file of the package."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    assert names >= {"asynchrony/engine.py", "asynchrony/solvers.py", "asynchrony/draws.py",
                     "asynchrony/delay_models.py", "asynchrony/protocols.py",
                     "core/snapshot.py", "benchmarks/bench_async.py",
                     "benchmarks/bench_detection.py", "examples/solve_poisson_async.py",
                     "configs/paper_poisson1d.py", "configs/pagerank_diffusion.py"}


def test_the_import_scan_covers_every_kernel_package():
    """The scan lists files by walking the package: new kernel packages
    are in it without being named anywhere."""
    kernels = {p.parent.name for p in PORT_FILES if p.name == "ops.py"}
    assert kernels >= {"flash_attention", "mrd_combine", "paged_attention", "rmsnorm",
                       "selective_scan"}


def test_train_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import step as step_lib
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1", "--dp", "3"])
    cfg = registry.get_smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        step_lib.make_train_step(cfg, step_lib.TrainConfig(), dp=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticPipeline(cfg, DataConfig(batch=2, seq_len=8))


def test_the_import_scan_covers_the_collectives_layer():
    """The schedules, executors (``torch.distributed``), plans, transforms
    and bench_mrd are scanned like every other file of the package."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    assert names >= {"collectives/__init__.py", "collectives/schedules.py",
                     "collectives/executors.py", "collectives/plans.py",
                     "collectives/transforms.py", "collectives/buckets.py",
                     "benchmarks/bench_mrd.py"}


def test_bench_mrd_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.benchmarks import bench_mrd

    for argv in ([], ["--quick"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_mrd.main(argv)


def test_bench_mrd_runs_on_cpu_when_asked(tmp_path):
    """``python -m repro_torch.benchmarks.bench_mrd --quick --device cpu``:
    its message and step rows are the paper's closed forms (p0 log2 p0 +
    2 (p - p0) messages, log2 p0 + 2 steps, the shifts skipped when p is a
    power of two), and every measured row names the CPU."""
    import json
    import os
    import subprocess
    import sys

    out = tmp_path / "bench_mrd.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.bench_mrd", "--quick",
                           "--device", "cpu", "--json", str(out)], capture_output=True,
                          text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    payload = json.loads(out.read_text())
    model = {r["name"]: r["derived"] for r in payload["model"]}
    for p in (2, 3, 4, 5, 7, 8, 12, 16, 24, 32, 64, 100, 256):
        mu0 = p.bit_length() - 1
        p0, extra = 1 << mu0, p - (1 << mu0)
        assert model[f"mrd_messages_p{p}"] == p0 * mu0 + 2 * extra
        assert model[f"mrd_steps_p{p}"] == mu0 + (2 if extra else 0)
    assert payload["device"] == "cpu" and payload["measured"]
    assert all(r["device"] == "cpu" and r["us_per_call"] > 0 for r in payload["measured"])
    names = {r["name"] for r in payload["measured"]}
    assert {"sim_rabenseifner_int8_p8_n4096", "sim_grad64_bucketed_eager_p8"} <= names
    assert "mrd_messages_p5,0.0,10" in proc.stdout
