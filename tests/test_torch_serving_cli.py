"""The port's serving CLI (static path, ``--arrival``, ``--tenants``),
``bench_serve`` and the ``serve_decode`` example, on the CPU.

- The static path at smoke size prints the reference's ``prefill:``,
  ``decode:`` and ``sample token ids:`` lines.
- ``--arrival`` / ``--tenants``: the request stream (ids, arrivals,
  tenants, prompts, budgets, priorities, SLAs) equals the reference CLI's
  at the same seed and workload (both engines stubbed out once they have
  the requests; a tenant's budgets depend on the pool's length, which the
  paged pool rounds up to whole blocks), and the port's run prints the
  SLA and per-tenant lines.
- ``bench_serve --quick --device cpu`` writes its rows; the sysprefix
  pair's tokens are identical; the kill/join rows lose no request,
  resize three times and (LLM) prefill no slot again.  No timing gate
  runs here.
- Every new entry point raises without a card unless asked for the CPU.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as cli  # noqa: E402

TENANTS = "chat:3:sla=8:prio=2,batch:1:quota=4:gen=24"


class _Captured(Exception):
    pass


class _Engine:
    def __init__(self, workload, cfg):
        self.cfg = cfg

    def run(self, reqs):
        raise _Captured(reqs, self.cfg)


def _captured(main, argv):
    with pytest.raises(_Captured) as got:
        main(argv)
    return got.value.args


def _stream(reqs):
    return [(r.id, r.arrival, r.tenant, np.asarray(r.prompt).tolist(), r.max_new, r.priority,
             r.sla, r.eos) for r in reqs]


@pytest.mark.parametrize("extra", [
    ["--arrival", "poisson:0.5"],
    ["--arrival", "poisson:0.5", "--tenants", TENANTS, "--workload", "llm_decode"],
    ["--arrival", "bursty:0.2,2.0", "--tenants", TENANTS, "--workload", "llm_decode_paged"],
])
def test_request_stream_equals_the_reference_clis(monkeypatch, extra):
    from repro.launch import serve as ref_cli

    monkeypatch.setattr(ref_cli, "ServeEngine", _Engine)
    monkeypatch.setattr(cli, "ServeEngine", _Engine)
    argv = ["--arch", "llama3.2-1b", "--smoke", "--continuous", "--requests", "12",
            "--prompt-len", "10", "--gen", "12", "--seed", "3", "--max-retries", "1",
            "--steps-per-dispatch", "4"] + extra
    ref_reqs, ref_cfg = _captured(ref_cli.main, argv)
    reqs, cfg = _captured(cli.main, argv + ["--device", "cpu"])
    assert _stream(reqs) == _stream(ref_reqs)
    assert (cfg.quotas, cfg.max_retries, cfg.steps_per_dispatch) == (
        ref_cfg.quotas, ref_cfg.max_retries, ref_cfg.steps_per_dispatch)
    assert max(r.arrival for r in reqs) > 0


def test_fixedpoint_request_stream_follows_arrival(monkeypatch):
    from repro.launch import serve as ref_cli

    monkeypatch.setattr(ref_cli, "ServeEngine", _Engine)
    monkeypatch.setattr(cli, "ServeEngine", _Engine)
    argv = ["--continuous", "--workload", "fixedpoint_solve", "--n", "24", "--dp", "3",
            "--requests", "6", "--gen", "300", "--arrival", "poisson:0.5", "--seed", "2"]
    ref_reqs, _ = _captured(ref_cli.main, argv)
    reqs, _ = _captured(cli.main, argv + ["--device", "cpu"])
    assert [(r.id, r.arrival, r.max_new, r.priority, r.sla) for r in reqs] == [
        (r.id, r.arrival, r.max_new, r.priority, r.sla) for r in ref_reqs]
    for a, b in zip(reqs, ref_reqs):
        np.testing.assert_array_equal(a.payload, np.asarray(b.payload))


def test_tenant_cli_prints_sla_and_tenant_lines(capsys):
    eng = cli.main(["--arch", "llama3.2-1b", "--smoke", "--continuous", "--slots", "4",
                    "--requests", "12", "--scheduler", "sla_edf", "--arrival", "poisson:0.5",
                    "--tenants", TENANTS, "--device", "cpu"])
    out = capsys.readouterr().out
    s = eng.summary()
    assert s["completed"] == 12 and set(s["tenants"]) == {"chat", "batch"}
    assert f"  SLA {s['sla_met']}/{s['sla_total']} met | goodput {s['goodput_ok']} (" in out
    assert f"| replica-ticks {s['replica_ticks']}" in out
    for name in ("batch", "chat"):
        assert f"  tenant {name}: {s['tenants'][name]['completed']} done" in out
    batch = [r for r in eng.results.values() if r.tenant == "batch"]
    for t in range(s["ticks"]):  # quota 4
        assert sum(r.admit_tick <= t <= r.retire_tick for r in batch) <= 4


def test_static_path_prints_its_three_lines(capsys):
    r = cli.main(["--arch", "llama3.2-1b", "--smoke", "--batch", "3", "--prompt-len", "8",
                  "--gen", "6", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: 24 tokens in ") and "tok/s" in out[0]
    assert out[1].startswith("decode:  18 tokens in ") and "ms/step" in out[1]
    assert out[2] == f"sample token ids: {r['tokens'][0][:16].tolist()}"
    assert r["tokens"].shape == (3, 6)
    assert r["cache_bytes"] == 2 * 2 * 3 * 14 * 2 * 16 * 4  # k, v [L, B, P + gen, KV, hd] fp32


def test_bench_serve_quick_writes_rows(tmp_path, capsys):
    from repro_torch.benchmarks import bench_serve

    # one intra-op thread: beside the other test workers, torch's thread pool
    # on these tiny ops oversubscribes the cores (25x the test's solo time)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path / "bench_serve.json"
        payload = bench_serve.main(["--quick", "--device", "cpu", "--json", str(out)])
    finally:
        torch.set_num_threads(n)
    rows = {r["name"]: r for r in json.loads(out.read_text())["sweep"]}
    assert payload["sweep"] == list(rows.values())
    assert set(rows) == {"serve_static_baseline", "serve_llm_fcfs_burst",
                         "serve_llm_contig_sysprefix", "serve_llm_paged_sysprefix",
                         "serve_llm_elastic_killjoin", "serve_fixedpoint_elastic_killjoin",
                         "serve_fixedpoint_fcfs"}
    for name in ("serve_llm_elastic_killjoin", "serve_fixedpoint_elastic_killjoin"):
        el = rows[name]
        assert (el["trajectory"], el["resizes"], el["lost_requests"]) == ("4->3->5->4", 3, 0)
    assert rows["serve_llm_elastic_killjoin"]["reprefills"] == 0
    el = rows["serve_fixedpoint_elastic_killjoin"]
    assert el["converged"] == el["requests"] == 18
    paged = rows["serve_llm_paged_sysprefix"]
    assert paged["bit_exact_vs_contig"] and paged["prefix_saved_blocks"] > 0
    assert paged["concurrency_per_byte_vs_contig"] >= 1.5
    assert rows["serve_fixedpoint_fcfs"]["converged"] == rows["serve_fixedpoint_fcfs"]["requests"]
    assert "serve_llm_fcfs_burst," in capsys.readouterr().out


def test_example_runs_on_cpu_when_asked(capsys):
    from repro_torch.examples import serve_decode

    eng = serve_decode.main(["--device", "cpu"])
    assert eng.summary()["completed"] == 8
    assert "8 requests, " in capsys.readouterr().out


def test_new_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.benchmarks import bench_serve
    from repro_torch.configs import registry
    from repro_torch.examples import serve_decode

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "llama3.2-1b", "--smoke", "--batch", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.static_serve(registry.get_smoke_config("llama3.2-1b"), batch=1, prompt_len=2, gen=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "llama3.2-1b", "--smoke", "--continuous", "--tenants", TENANTS])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_serve.main(["--quick"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_decode.main([])
    # the elastic flags: the controller serves on the default device too
    elastic = ["--arch", "llama3.2-1b", "--smoke", "--continuous", "--dp", "4"]
    for extra in (["--elastic-policy", "grow_on_join", "--kill", "6:2", "--join", "16:4,5"],
                  ["--autoscale", "--slots-per-replica", "2", "--max-extent", "6"],
                  ["--stall", "4:1:5", "--unstall", "8:1", "--kill", "9:3:silent"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(elastic + extra)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--continuous", "--workload", "fixedpoint_solve", "--n", "60", "--dp", "4",
                  "--elastic-policy", "shrink_on_failure", "--kill", "3:1"])
