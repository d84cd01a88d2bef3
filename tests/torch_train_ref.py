"""Helpers shared by the port's training parity tests: the reference's
smoke params with random values in the leaves it initialises to
constants, the same batch for both packages, flat gradient and state
dicts keyed by the reference's paths, and the reference's train steps run
in a subprocess with forced host devices."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import transformer as ref_tf
from repro_torch.collectives import buckets
from repro_torch.models import convert

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke configs' tensors are tiny: one intra-op thread a test
    process runs them as fast as many, and the test workers do not
    oversubscribe the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomized_params(rcfg, seed: int):
    """``init_params`` of the reference with every constant leaf (norms,
    biases, conv biases, mamba's D, dt_bias and mamba2's A_log) moved by
    N(0, 0.1) noise, so no parameter's gradient is degenerate."""
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def move(leaf):
        a = np.asarray(leaf)
        if a.size and np.all(a == a.reshape(-1)[0]):
            a = a + rng.standard_normal(a.shape).astype(a.dtype) * np.asarray(0.1, a.dtype)
        return jnp.asarray(a)

    return jax.tree.map(move, rparams)


def batch(cfg, seed: int, B: int = 3, S: int = 12):
    """A train batch as numpy arrays: tokens/labels (a few labels masked),
    the vision patches or the audio frames."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels[1, :3] = -1
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((B, S, 80)).astype(np.float32), "labels": labels}
    out = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32), "labels": labels}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal((B, cfg.n_frontend_tokens, 1024)).astype(np.float32)
    return out


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
            for k, v in b.items()}


def flat(tree, prefix: str = "") -> dict:
    """{reference key path: numpy array} of a jax or numpy tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)
    return out


def flat_port(tree) -> dict:
    """{reference key path: numpy array} of a port param tree."""
    leaves, paths = buckets.tree_flatten(convert.reference_tree(tree))
    return {"/".join(p): t.detach().float().numpy() for p, t in zip(paths, leaves)}


def run_reference(script: str, out_path, devices: int, timeout: int = 900) -> dict:
    """Run ``script`` (its first argument: the ``.npz`` path it writes) in a
    subprocess with ``devices`` forced host devices; returns the arrays."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices} "
                        "--xla_cpu_multi_thread_eigen=false")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", script, str(out_path)], capture_output=True,
                          text=True, env=env, timeout=timeout)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-5000:]}"
    z = np.load(out_path)
    return {k: z[k] for k in z.files}


def tree(z: dict, prefix: str) -> dict:
    """The nested dict under ``prefix`` of a flat ``{path: array}`` dict."""
    out: dict = {}
    for k, v in z.items():
        if k.startswith(prefix):
            parts = k[len(prefix):].split("/")
            node = out
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
    return out


# the reference's train-step recorder: MODES, ARCHS (arch -> [modes]),
# STEPS, LR, DPS, TCFG_KW and EXTRA are prepended by the caller; each EXTRA
# entry is one more run (tag, arch, mode, dp, steps, its own TrainConfig
# and OptimizerConfig fields, and optionally tp: a ("data", "model") mesh
# of dp x tp, and batch: the global batch, default 2 dp), recorded under
# its tag
RECORD = """
import sys
import jax, numpy as np
from jax.sharding import NamedSharding
from repro import compat
from repro.configs import registry
from repro.data.pipeline import DataConfig, SyntheticPipeline
from repro.distributed import step as step_lib
from repro.optim.optimizer import OptimizerConfig

out = {}

def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[prefix + key] = np.asarray(jax.device_get(leaf))

def record(tag, arch, mode, dp, steps, tcfg_kw, opt_kw, tp=1, batch=None):
    shape, names = ((dp, tp), ("data", "model")) if tp > 1 else ((dp,), ("data",))
    mesh = compat.make_mesh(shape, names, devices=jax.devices()[:dp * tp],
                            axis_types=compat.default_axis_types(len(shape)))
    cfg = registry.get_smoke_config(arch)
    kw = dict(microbatches=1, remat="none")
    kw.update(tcfg_kw)
    tcfg = step_lib.TrainConfig(
        grad_sync=mode, monitor=mode != "local_sgd",
        monitor_mode=MODES.get(mode, "inexact"), monitor_threshold=6.0,
        bucket_bytes=1 << 15,
        optimizer=OptimizerConfig(lr=LR, schedule="const", warmup_steps=0, grad_clip=1.0,
                                  **opt_kw),
        **kw)
    train_step, init_state, state_specs, _ = step_lib.make_train_step(cfg, mesh, tcfg)
    with mesh:
        state = init_state(jax.random.PRNGKey(0))
        state = jax.device_put(state, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                                   state_specs(state)))
        save(tag + "init/", state)
        pipe = SyntheticPipeline(cfg, DataConfig(batch=batch or 2 * dp, seq_len=16, seed=0), mesh)
        jstep = jax.jit(train_step)
        for i in range(steps):
            b = pipe.next_batch()
            save(f"{tag}batch{i}/", b)
            state, metrics = jstep(state, b)
            save(f"{tag}metrics{i}/", metrics)
            save(f"{tag}state{i + 1}/", state)

for dp in DPS:
    for arch, modes in ARCHS.items():
        for mode in modes:
            record(f"{arch}/{mode}/{dp}/", arch, mode, dp, STEPS, TCFG_KW, {})
for x in EXTRA:
    record(x["tag"], x["arch"], x["mode"], x["dp"], x["steps"], x.get("tcfg", {}),
           x.get("optimizer", {}), x.get("tp", 1), x.get("batch"))
np.savez(sys.argv[1], **out)
"""


def record_script(archs: dict, *, dps=(3,), steps: int = 3, lr: float = 1e-2,
                  modes: dict = None, extra=(), **tcfg_kw) -> str:
    """:data:`RECORD` for ``archs`` ({arch: [grad-sync modes]}) and the
    ``extra`` runs."""
    head = (f"ARCHS = {archs!r}\nDPS = {tuple(dps)!r}\nSTEPS = {steps}\nLR = {lr}\n"
            f"MODES = {modes or {}!r}\nTCFG_KW = {tcfg_kw!r}\nEXTRA = {list(extra)!r}\n")
    return head + RECORD
