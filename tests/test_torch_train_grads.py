"""``forward_train`` and its gradients against the reference's
``jax.value_and_grad``, for the smoke config of every registered arch
(minicpm-2b aside, see ``ARCHS``), the
port at remat ``none``, ``full`` and ``dots`` (fp32, the same weights
through ``params_from_reference``, constant leaves moved off their
constants; the reference once an arch, jitted, with no remat policy: its
policies choose what the backward pass keeps, not the values);
the audio family's pieces (config, ``n_params``, the tanh-gelu MLP, the
frontend's batch); and the pipeline's cursor.

Tolerances (fp32; the two sides sum in different orders): the loss and
the per-sequence losses within 1e-5 (relative 1e-5); every gradient leaf
within 1e-5 + 1e-4 x its largest magnitude.  The port's three remat
policies give the same loss and gradients as each other within 1e-6:
they recompute the same ops in the same order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as RefPipeline  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.distributed import step as step_lib  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

from torch_train_ref import (  # noqa: E402,F401
    batch,
    flat,
    flat_port,
    one_thread,
    randomized_params,
    torch_batch,
)

# every registered arch but minicpm-2b, whose stack is llama3.2-1b's (the
# same leaves and ops; one K/V head a query head where llama groups them),
# to keep the file's time down
ARCHS = tuple(a for a in registry.list_archs() if a != "minicpm-2b")


@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    arch = request.param
    rcfg, cfg = ref_registry.get_smoke_config(arch), registry.get_smoke_config(arch)
    rparams = randomized_params(rcfg, 3)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    b = batch(cfg, 7)
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    (loss, met), g = jax.jit(jax.value_and_grad(
        lambda p: ref_tf.forward_train(p, rb, rcfg), has_aux=True))(rparams)
    ref = (float(loss), np.asarray(met["per_example"]), flat(g))
    return arch, cfg, params, b, ref, {}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_gradients_match_reference(arch_setup, remat):
    arch, cfg, params, b, (rloss, rper, rgrads), ours = arch_setup
    grads, loss, met = step_lib.microbatched_grads(params, torch_batch(b), cfg, remat, 1)
    np.testing.assert_allclose(float(loss), rloss, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(met["per_example"].numpy(), rper, atol=1e-5, rtol=1e-5)
    g = flat_port(grads)
    assert sorted(g) == sorted(rgrads), arch
    for k, ref in rgrads.items():
        assert g[k].shape == ref.shape, k
        tol = 1e-5 + 1e-4 * float(np.abs(ref).max())
        np.testing.assert_allclose(g[k], ref, rtol=0, atol=tol, err_msg=f"{arch} {remat} {k}")
    ours[remat] = (float(loss), g)
    if len(ours) == 3:  # the three policies recompute the same ops
        base_loss, base = ours["none"]
        for r in ("full", "dots"):
            assert abs(ours[r][0] - base_loss) <= 1e-6
            for k in base:
                np.testing.assert_allclose(ours[r][1][k], base[k], rtol=0, atol=1e-6)


def test_audio_config_and_n_params_are_the_references():
    for get in ("get_config", "get_smoke_config"):
        cfg = getattr(registry, get)("hubert-xlarge")
        rcfg = getattr(ref_registry, get)("hubert-xlarge")
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
                  "causal", "frontend", "act", "family", "tie_embeddings"):
            assert getattr(cfg, f) == getattr(rcfg, f), f
        assert cfg.n_params() == rcfg.n_params() and cfg.is_encoder_only
    full = registry.get_config("hubert-xlarge")
    assert (full.n_layers, full.d_model, full.n_heads, full.head_dim, full.d_ff,
            full.vocab) == (48, 1280, 16, 80, 5120, 512)
    assert not registry.get_config("llama3.2-1b").is_encoder_only
    with pytest.raises(ValueError, match="act 'relu'"):
        registry.override(full, act="relu")
    with pytest.raises(ValueError, match="int8 KV cache"):
        registry.override(full, kv_cache_dtype="int8")  # the plain decoder stack only


def test_init_params_has_the_references_leaves():
    for arch in ARCHS:
        cfg, rcfg = registry.get_smoke_config(arch), ref_registry.get_smoke_config(arch)
        ours = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        ref = jax.eval_shape(lambda: ref_tf.init_params(rcfg, jax.random.PRNGKey(0)))
        ref = {"/".join(str(getattr(k, "key", k)) for k in p): tuple(leaf.shape)
               for p, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
        assert {k: v.shape for k, v in flat_port(ours).items()} == ref, arch


def test_gelu_mlp_matches_reference():
    """The two-matrix MLP with jax.nn.gelu's tanh approximation (the erf
    form differs by ~1e-3 here): fp32 within 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    p = {"w1": rng.standard_normal((16, 32)).astype(np.float32),
         "w2": rng.standard_normal((32, 16)).astype(np.float32) / 6}
    ref = np.asarray(ref_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                          jnp.asarray(x), "gelu"))
    ours = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), "gelu")
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    erf = (torch.nn.functional.gelu(torch.from_numpy(x) @ torch.from_numpy(p["w1"]))
           @ torch.from_numpy(p["w2"]))
    assert float((erf - ours).abs().max()) > 1e-4  # the exact form is another function
    g = torch.Generator().manual_seed(0)
    init = layers.mlp_init(g, (3,), 16, 32, torch.float32, "gelu")
    assert {k: tuple(v.shape) for k, v in init.items()} == {"w1": (3, 16, 32), "w2": (3, 32, 16)}


def test_audio_batches_have_the_references_shapes():
    for arch in ("hubert-xlarge", "internvl2-1b"):
        cfg, rcfg = registry.get_smoke_config(arch), ref_registry.get_smoke_config(arch)
        ours = SyntheticPipeline(cfg, DataConfig(batch=4, seq_len=12), "cpu").next_batch()
        ref = RefPipeline(rcfg, RefDataConfig(batch=4, seq_len=12)).next_batch()
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert tuple(ours[k].shape) == tuple(ref[k].shape), (arch, k)
            assert (ours[k].dtype == torch.float32) == (np.asarray(ref[k]).dtype == np.float32)
    frames = SyntheticPipeline(registry.get_smoke_config("hubert-xlarge"),
                               DataConfig(batch=2, seq_len=8), "cpu").next_batch()
    assert int(frames["labels"].max()) < 64 and int(frames["labels"].min()) >= 0


def test_pipeline_cursor_resumes_the_stream():
    cfg = registry.get_smoke_config("llama3.2-1b")
    a = SyntheticPipeline(cfg, DataConfig(batch=2, seq_len=8, seed=3), "cpu")
    for _ in range(3):
        a.next_batch()
    st = a.state_dict()
    assert st == {"step": 3, "seed": 3}
    b = SyntheticPipeline(cfg, DataConfig(batch=2, seq_len=8, seed=3), "cpu")
    b.load_state_dict(st)
    x, y = a.next_batch(), b.next_batch()
    assert all(torch.equal(x[k], y[k]) for k in x)
    c = SyntheticPipeline(cfg, DataConfig(batch=2, seq_len=8, seed=4), "cpu")
    with pytest.raises(ValueError, match="data seed mismatch"):
        c.load_state_dict(st)


def test_serving_refuses_the_encoder_only_arch(capsys):
    """As the reference's CLI: an encoder-only arch has no decode serving."""
    for argv in (["--continuous"], ["--batch", "2", "--prompt-len", "4"]):
        with pytest.raises(SystemExit, match="hubert-xlarge is encoder-only: no decode serving"):
            serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"] + argv)
