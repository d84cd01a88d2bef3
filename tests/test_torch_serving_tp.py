"""The serving CLI tensor-parallel: gloo worlds of the port at ``--tp`` 2
and 4 against the reference CLI at the same ``--tp`` on forced host
devices.

One subprocess runs the reference CLI (``repro.launch.serve.main``) for
every continuous case, recording its engine's weights and each request's
tokens, admission and retirement ticks, and the reference's static path
(its ``_static_main`` steps on a ``(dp, tp)`` mesh, every greedy token
kept).  One gloo world a mesh then runs the port's CLI
(``launch.serve.run``, after the world is joined; ``torch_dist_worker``'s
``serve_cli``) on those weights, each rank on its blocks of them:

- llama (paged pool) at ``tp`` 2 and 4: 4 query heads, 2 K/V heads (at
  ``tp`` 4 repeated twice to shard);
- qwen2.5 (paged) at ``tp`` 2 and 4: 5 heads, replicated, every rank the
  whole attention;
- mixtral (contiguous pool, prompts up to 40 tokens, past its 32-token
  window) at ``tp`` 2:
  the experts' d_ff over ``"model"``;
- falcon-mamba (contiguous) and zamba2 (paged) at ``tp`` 2: the mamba
  layers on the rank's channels;
- the static path at ``(dp 2, tp 2)``: each data rank its half of the
  batch.

Every rank's tokens and ticks equal the reference's exactly (the ranks'
engines make the same decisions).  Also: ``--tp`` without a world exits,
and ``fixedpoint_solve`` ignores it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as W  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

from torch_train_ref import one_thread, run_reference, tree  # noqa: E402,F401

COMMON, CASES, STATIC = W.SERVE_COMMON, W.SERVE_CASES, W.SERVE_STATIC

SERVE_REF = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.distributed import step as step_lib
from repro.launch import serve as ref_cli
from repro.launch.train import build_mesh
from repro.models import transformer

out = {}

def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[prefix + key] = np.asarray(jax.device_get(leaf))

engines = []

class Recorded(ref_cli.ServeEngine):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        engines.append(self)

ref_cli.ServeEngine = Recorded
for tag, argv in RUNS.items():
    ref_cli.main(argv)
    eng = engines.pop()
    save(tag + "params/", eng.workload.params)
    for i, r in eng.results.items():
        out[f"{tag}res/{i}/output"] = np.asarray(r.output)
        out[f"{tag}res/{i}/ticks"] = np.array([r.admit_tick, r.retire_tick, r.n_tokens])

# the static path: ref_cli._static_main's steps, every greedy token kept
s = STATIC
cfg = registry.get_smoke_config(s["arch"])
mesh = build_mesh(s["dp"], s["tp"])
serve_step, _ = step_lib.make_serve_step(cfg, mesh)
prefill_step, _ = step_lib.make_cached_prefill_step(cfg, mesh)
with mesh:
    params = transformer.init_params(cfg, jax.random.PRNGKey(0))
    cache = transformer.init_cache(cfg, s["batch"], s["prompt_len"] + s["gen"])
    prompt = jax.random.randint(jax.random.PRNGKey(1), (s["batch"], s["prompt_len"]), 0,
                                cfg.vocab)
    jstep, jprefill = jax.jit(serve_step), jax.jit(prefill_step)
    logits, cache = jprefill(params, prompt, cache)
    toks = jnp.argmax(logits, -1).astype(jnp.int32)
    outs = []
    for i in range(s["gen"]):
        outs.append(np.asarray(toks))
        logits, cache = jstep(params, toks, cache, jnp.int32(s["prompt_len"] + i))
        toks = jnp.argmax(logits, -1).astype(jnp.int32)
save("static/params/", params)
out["static/prompt"] = np.asarray(prompt)
out["static/tokens"] = np.stack(outs, 1)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    runs = {t: argv + COMMON + ["--tp", str(tp)] for t, (tp, argv) in CASES.items()}
    script = f"RUNS = {runs!r}\nSTATIC = {STATIC!r}\n" + SERVE_REF
    return run_reference(script, tmp_path_factory.mktemp("ref") / "ref.npz", devices=4)


def port_params(z, prefix, arch):
    return params_from_reference(tree(z, prefix), registry.get_smoke_config(arch), "cpu")


@pytest.fixture(scope="module")
def worlds(reference_run, tmp_path_factory):
    z = reference_run
    by_tp = {}
    for tag, (tp, argv) in CASES.items():
        arch = argv[argv.index("--arch") + 1]
        by_tp.setdefault(tp, {})[tag] = (argv + COMMON + ["--tp", str(tp)],
                                         port_params(z, tag + "params/", arch), None)
    out = {}
    for tp, runs in sorted(by_tp.items()):
        out[tp] = W.run_world(tmp_path_factory.mktemp(f"serve_tp{tp}"), "serve_cli", (1, tp),
                              ("data", "model"), args={"runs": runs}, deadline_s=300)
    s = STATIC
    argv = ["--arch", s["arch"], "--smoke", "--batch", str(s["batch"]), "--prompt-len",
            str(s["prompt_len"]), "--gen", str(s["gen"]), "--dp", str(s["dp"]), "--tp",
            str(s["tp"])]
    runs = {"static/": (argv, port_params(z, "static/params/", s["arch"]),
                        torch.from_numpy(z["static/prompt"].astype(np.int64)))}
    out["static"] = W.run_world(tmp_path_factory.mktemp("serve_static"), "serve_cli",
                                (s["dp"], s["tp"]), ("data", "model"), args={"runs": runs},
                                deadline_s=300)
    return out


@pytest.mark.parametrize("tag", sorted(CASES))
def test_tp_serving_matches_the_reference_cli(reference_run, worlds, tag):
    z = reference_run
    tp, _ = CASES[tag]
    ref = sorted({int(k[len(tag) + 4:].split("/")[0]) for k in z if k.startswith(tag + "res/")})
    assert ref
    for rank, got in enumerate(worlds[tp]):
        ids = sorted({int(k[len(tag):].split("/")[0]) for k in got if k.startswith(tag)})
        assert ids == ref, (rank, ids)
        for i in ref:
            np.testing.assert_array_equal(got[f"{tag}{i}/output"].numpy(),
                                          z[f"{tag}res/{i}/output"], err_msg=f"{rank} {i}")
            assert got[f"{tag}{i}/ticks"].tolist() == z[f"{tag}res/{i}/ticks"].tolist(), (rank, i)


def test_tp_static_path_matches_the_reference(reference_run, worlds):
    want = reference_run["static/tokens"]
    assert want.shape == (STATIC["batch"], STATIC["gen"])
    for rank, got in enumerate(worlds["static"]):
        np.testing.assert_array_equal(got["static/tokens"].numpy(), want, err_msg=str(rank))


def test_tp_needs_a_world_and_fixedpoint_ignores_it():
    with pytest.raises(SystemExit, match="needs a world of 2 ranks"):
        cli.main(["--arch", "llama3.2-1b", "--smoke", "--continuous", "--tp", "2",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs a world of 4 ranks"):
        cli.main(["--arch", "llama3.2-1b", "--smoke", "--dp", "2", "--tp", "2",
                  "--device", "cpu"])
    eng = cli.main(["--continuous", "--workload", "fixedpoint_solve", "--n", "24", "--dp", "3",
                    "--requests", "2", "--gen", "300", "--tp", "4", "--device", "cpu"])
    assert eng.summary()["completed"] == 2
