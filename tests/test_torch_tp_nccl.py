"""The ``gspmd`` trainer and the TP serving CLI as NCCL worlds, one card a
rank, against the same port in one process on card 0.

These need four NVIDIA cards (NCCL puts no two ranks of one communicator
on one card) and skip otherwise.  On a node of four cards, from the
repository root:

    python -m pytest -q -m cuda tests/test_torch_tp_nccl.py

They rerun the world scenarios of ``test_torch_gspmd_world.py`` and
``test_torch_serving_tp.py`` (``tests/torch_dist_worker.py``'s
``gspmd_forced`` and ``serve_cli``, the same cases) on the cards.  There
is no reference on that machine, so the stacked-rows ``gspmd`` step on
card 0 takes its place: each world step starts from the stacked run's
state before it (teacher-forced) and its state after is held to the
stacked run's by ``torch_dist_worker.close_states`` (the tensor-parallel
sums run in other orders: ``test_torch_train_families``' exact-sync
rule), the loss within 1e-5 and the grad norm within
1e-4 relative; the serving worlds serve on weights drawn once on card 0,
against the CLI in one process on the same weights: tokens, admission
and retirement ticks equal.  TF32 is off.  This file imports neither JAX
nor the reference package.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402

pytestmark = pytest.mark.cuda
STEPS = 2


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices, one a rank")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def stacked_runs(mesh):
    """The stacked-rows gspmd steps of this mesh's cases on card 0: for
    each, [(state before, global batch)], and by step the flat state after,
    the metrics and the flat state before."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import step as step_lib
    from repro_torch.models import convert

    runs, after, before_flat = {}, {}, {}
    for tag, (arch, m, kw, batch) in W.GSPMD_CASES.items():
        if m != mesh:
            continue
        cfg = registry.get_smoke_config(arch)
        tcfg = W.gspmd_tcfg(**kw)
        step = step_lib.make_train_step(cfg, tcfg, dp=m[0], device="cuda")
        state = step.init_state(torch.Generator(device="cuda").manual_seed(0))
        pipe = SyntheticPipeline(cfg, DataConfig(batch=batch or 2 * m[0], seq_len=16), "cuda")
        steps = []
        for i in range(STEPS):
            b = pipe.next_batch()
            # a copy: the step updates the optimizer trees in place
            before = W.to(copy.deepcopy(convert.train_state_to_reference(state)), "cpu")
            before_flat[f"{tag}step{i + 1}"] = W.flat(before, "state")
            steps.append((W.to(convert.train_state_from_reference(before, cfg, "cpu"), "cpu"),
                          W.to(b, "cpu")))
            state, metrics = step(state, b)
            after[f"{tag}step{i + 1}"] = (
                W.to(W.flat(copy.deepcopy(convert.train_state_to_reference(state)), "state"),
                     "cpu"),
                {k: v.detach().cpu() for k, v in metrics.items()},
                before_flat[f"{tag}step{i + 1}"])
        runs[tag] = (arch, tcfg, steps)
    return runs, after


@pytest.fixture(scope="module")
def gspmd_worlds(cards, tmp_path_factory):
    out = {}
    for mesh in sorted({m for _, m, _, _ in W.GSPMD_CASES.values()}):
        runs, after = stacked_runs(mesh)
        ranks = W.run_world(tmp_path_factory.mktemp(f"nccl_gspmd_{mesh[0]}x{mesh[1]}"),
                            "gspmd_forced", *W.mesh_shape(mesh), args={"runs": runs},
                            device="cuda", deadline_s=600, pg_timeout_s=300)
        out[mesh] = (ranks, after)
    return out


@pytest.mark.parametrize("tag", sorted(W.GSPMD_CASES))
def test_nccl_gspmd_world_matches_the_stacked_step(gspmd_worlds, tag):
    ranks, after = gspmd_worlds[W.GSPMD_CASES[tag][1]]
    for i in range(1, STEPS + 1):
        prefix = f"{tag}step{i}"
        state, metrics, before = after[prefix]
        got = {k[len(prefix) + 1:]: v for k, v in ranks[0].items()
               if k.startswith(prefix + "/state/")}
        W.close_states(got, state, before, prefix)
        for rank in ranks:
            np.testing.assert_allclose(float(rank[f"{prefix}/metrics/loss"]),
                                       float(metrics["loss"]), atol=1e-5, rtol=0)
            np.testing.assert_allclose(float(rank[f"{prefix}/metrics/grad_norm"]),
                                       float(metrics["grad_norm"]), rtol=1e-4)
        assert bool(ranks[0][f"{prefix}/metrics/converged"]) == bool(metrics["converged"])


def serve_in_one_process(argv, params, prompt=None):
    """The serving CLI in this process on card 0 (``params``: whole)."""
    import functools

    from repro_torch.launch import serve as cli
    from repro_torch.serving import make_workload

    saved = cli.make_workload, cli.static_serve
    cli.make_workload = functools.partial(make_workload, params=params)
    cli.static_serve = functools.partial(cli.static_serve, params=params, prompt=prompt)
    try:
        return cli.run(cli.build_parser().parse_args(list(argv) + ["--device", "cuda"]))
    finally:
        cli.make_workload, cli.static_serve = saved


@pytest.fixture(scope="module")
def serve_worlds(cards, tmp_path_factory):
    from repro_torch.configs import registry
    from repro_torch.models import transformer

    def weights(arch):
        cfg = registry.get_smoke_config(arch)
        return W.to(transformer.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                            "cuda"), "cpu")

    by_tp, plain = {}, {}
    for tag, (tp, argv) in W.SERVE_CASES.items():
        params = weights(argv[argv.index("--arch") + 1])
        full = argv + W.SERVE_COMMON + ["--tp", str(tp)]
        by_tp.setdefault(tp, {})[tag] = (full, params, None)
        eng = serve_in_one_process(full, W.to(params, "cuda"))
        plain[tag] = {i: (np.asarray(r.output), [r.admit_tick, r.retire_tick, r.n_tokens])
                      for i, r in eng.results.items()}
    out = {tp: W.run_world(tmp_path_factory.mktemp(f"nccl_serve_tp{tp}"), "serve_cli", (1, tp),
                           ("data", "model"), args={"runs": runs}, device="cuda",
                           deadline_s=600, pg_timeout_s=300)
           for tp, runs in sorted(by_tp.items())}
    s = W.SERVE_STATIC
    params = weights(s["arch"])
    prompt = torch.randint(0, 256, (s["batch"], s["prompt_len"]),
                           generator=torch.Generator().manual_seed(1))
    argv = ["--arch", s["arch"], "--smoke", "--batch", str(s["batch"]), "--prompt-len",
            str(s["prompt_len"]), "--gen", str(s["gen"]), "--dp", str(s["dp"]), "--tp",
            str(s["tp"])]
    plain["static/"] = serve_in_one_process(argv, W.to(params, "cuda"),
                                            prompt.cuda())["tokens"]
    out["static"] = W.run_world(tmp_path_factory.mktemp("nccl_serve_static"), "serve_cli",
                                (s["dp"], s["tp"]), ("data", "model"),
                                args={"runs": {"static/": (argv, params, prompt)}},
                                device="cuda", deadline_s=600, pg_timeout_s=300)
    return out, plain


@pytest.mark.parametrize("tag", sorted(W.SERVE_CASES))
def test_nccl_tp_serving_matches_one_process(serve_worlds, tag):
    out, plain = serve_worlds
    for rank, got in enumerate(out[W.SERVE_CASES[tag][0]]):
        for i, (tokens, ticks) in plain[tag].items():
            np.testing.assert_array_equal(got[f"{tag}{i}/output"].numpy(), tokens,
                                          err_msg=f"{rank} {i}")
            assert got[f"{tag}{i}/ticks"].tolist() == ticks, (rank, i)


def test_nccl_tp_static_path_matches_one_process(serve_worlds):
    out, plain = serve_worlds
    for rank, got in enumerate(out["static"]):
        np.testing.assert_array_equal(got["static/tokens"].numpy(), plain["static/"],
                                      err_msg=str(rank))
