"""The port's qwen2.5-32b, minicpm-2b and internvl2-1b against the
reference's, on their fp32 smoke configs with the reference's weights
carried across by ``repro_torch.models.convert``.

The reference initialises qwen2.5's ``bq``/``bk``/``bv`` to zeros, so a
parity check of its own ``init_params`` would never see the bias: random
biases (N(0, 0.25)) are written into the reference's tree before it is
converted.

- Every config field and ``n_params`` equal the reference's; the port's
  fresh weights have the reference's shapes.
- The whole-prompt forward (``make_prefill_step``), the cached prefill and
  24 decode steps on the contiguous cache, and 24 decode steps on a
  block-paged cache: logits within 2e-5 (fp32, summation order; the
  reference's attention is its Pallas kernel in interpret mode where it
  has one, the port's the plain version), cache rows within 2e-5, greedy
  tokens equal.
- internvl2's patch forward (the vision frontend's stub patches
  prepended): last logits and the train loss (labels past the patches)
  within 2e-5; the label offset is the patch count.
- An int8 cache on the qwen2.5 stack: the cached prefill's and 8 decode
  steps' logits within 1e-5, int8 rows equal but for a rounding tie (off
  by one in at most 1 in 1,000), scales within a relative 1e-5.
- The serving engine (``llm_decode``) at dp 3 and 5 and the serving CLI
  (``llm_decode_paged``, dp 3): every request's tokens and its admission
  and retirement ticks equal the reference's.  The CLI's static ``--batch``
  path serves each of the five new archs at smoke size.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.distributed import serve as ref_serve  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import serve  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import frontends, transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference, reference_tree  # noqa: E402
from torch_model_ref import (  # noqa: E402
    as_long,
    cached_decode,
    cli_matches_reference,
    engine_matches_reference,
    mesh,
    paged_decode_matches_reference,
    tokens,
    with_random_biases,
)

ARCHS = ["qwen2.5-32b", "minicpm-2b", "internvl2-1b"]
TOL = dict(atol=2e-5, rtol=0)
INT8_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg, rcfg = registry.get_smoke_config(arch), ref_registry.get_smoke_config(arch)
    rp = with_random_biases(ref_tf.init_params(rcfg, jax.random.PRNGKey(0)))
    np_params = jax.tree.map(np.asarray, rp)
    return cfg, rcfg, rp, np_params, params_from_reference(np_params, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    for get, rget in ((registry.get_config, ref_registry.get_config),
                      (registry.get_smoke_config, ref_registry.get_smoke_config)):
        cfg, rcfg = get(arch), rget(arch)
        ref_fields = dataclasses.asdict(rcfg)
        assert dataclasses.asdict(cfg) == {k: ref_fields[k] for k in dataclasses.asdict(cfg)}
        assert cfg.n_params() == rcfg.n_params()
        assert cfg.n_active_params() == rcfg.n_active_params() == cfg.n_params()
    assert registry.get_config("qwen2.5-32b").n_params() == 32_763_417_600
    cfg, _, _, np_params, params = _weights(arch)
    fresh = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(np.shape, reference_tree(fresh)) == jax.tree.map(np.shape, np_params)
    # the reference's count leaves out the qkv biases and the frontend's patch_proj
    extra = sum(fresh["layers"][n].numel() for n in ("bq", "bk", "bv") if n in fresh["layers"])
    extra += fresh["patch_proj"].numel() if "patch_proj" in fresh else 0
    assert sum(v.numel() for v in jax.tree.leaves(reference_tree(fresh))) - extra == \
        cfg.n_params()
    if cfg.qkv_bias:
        assert all(fresh["layers"][n].abs().max() == 0 for n in ("bq", "bk", "bv"))
        assert all(params["layers"][n].abs().min() > 0 for n in ("bq", "bk", "bv"))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    cfg, rcfg, rp, _, params = _weights(arch)
    toks = tokens(0, (2, 20), cfg.vocab)
    ours = serve.make_prefill_step(cfg, device="cpu")(params, {"tokens": as_long(toks)})
    rstep, _ = ref_serve.make_prefill_step(rcfg, mesh())
    theirs = jax.jit(rstep)(rp, {"tokens": jnp.asarray(toks)})
    assert ours.shape == (2, cfg.vocab)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_prefill_and_24_decode_steps_match_reference(arch):
    cfg, rcfg, rp, _, params = _weights(arch)
    cached_decode(cfg, rcfg, rp, params, B=2, S=12, steps=24, atol=TOL["atol"])


@pytest.mark.parametrize("arch", ARCHS)
def test_24_paged_decode_steps_match_reference(arch):
    cfg, rcfg, rp, _, params = _weights(arch)
    paged_decode_matches_reference(cfg, rcfg, rp, params, steps=24, atol=TOL["atol"])


def test_patch_forward_matches_reference():
    """internvl2: 8 stub patches (the smoke config's n_frontend_tokens)
    before 12 tokens; the label offset is the patch count."""
    cfg, rcfg, rp, _, params = _weights("internvl2-1b")
    B, P, S = 2, cfg.n_frontend_tokens, 12
    patches = frontends.vision_patches(torch.Generator().manual_seed(5), B, P,
                                       dtype=torch.float32)
    assert tuple(patches.shape) == (B, P, frontends.VISION_EMBED_DIM)
    frames = frontends.audio_frames(torch.Generator().manual_seed(5), B, 7)
    assert tuple(frames.shape) == (B, 7, frontends.AUDIO_FEAT_DIM)
    assert frames.dtype == torch.bfloat16
    toks = tokens(6, (B, S), cfg.vocab)
    labels = tokens(7, (B, S), cfg.vocab)
    labels[0, :3] = -1
    x, off = transformer._embed_inputs(params, as_long(toks), cfg, patches)
    assert off == P and tuple(x.shape) == (B, P + S, cfg.d_model)
    batch = {"tokens": as_long(toks), "patches": patches}
    rbatch = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches.numpy())}
    ours = serve.make_prefill_step(cfg, device="cpu")(params, batch)
    rstep, _ = ref_serve.make_prefill_step(rcfg, mesh())
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax.jit(rstep)(rp, rbatch)), **TOL)
    loss, metrics = transformer.forward_train(params, {**batch, "labels": as_long(labels)}, cfg)
    rloss, rmetrics = ref_tf.forward_train(rp, {**rbatch, "labels": jnp.asarray(labels)}, rcfg)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-6)
    np.testing.assert_allclose(metrics["per_example"].numpy(),
                               np.asarray(rmetrics["per_example"]), rtol=1e-6)
    assert metrics["ntok"].item() == float(rmetrics["ntok"]) == B * S - 3
    with pytest.raises(ValueError, match="vision frontend"):
        transformer._embed_inputs(*_weights("qwen2.5-32b")[4:], as_long(toks),
                                  registry.get_smoke_config("qwen2.5-32b"), patches)


def test_int8_cache_on_the_qwen_stack_matches_reference():
    cfg, rcfg, rp, _, params = _weights("qwen2.5-32b")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    rcfg8 = dataclasses.replace(rcfg, kv_cache_dtype="int8")
    cached_decode(cfg8, rcfg8, rp, params, B=2, S=10, steps=8, atol=INT8_ATOL)


# --- serving -----------------------------------------------------------------


@pytest.mark.parametrize("dp", [3, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_and_ticks_match_reference(arch, dp):
    _, _, rp, _, params = _weights(arch)
    engine_matches_reference(arch, dp, rp, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_as_the_reference_cli(monkeypatch, arch):
    eng = cli_matches_reference(monkeypatch, [
        "--arch", arch, "--smoke", "--continuous", "--workload", "llm_decode_paged",
        "--dp", "3", "--slots", "3", "--requests", "6"])
    assert eng.summary()["completed"] == 6


@pytest.mark.parametrize("arch", ARCHS + ["mixtral-8x7b", "llama4-scout-17b-a16e"])
def test_static_batch_path_serves_every_new_arch(arch, capsys):
    """``--batch`` (the static path: one cached prefill, then greedy steps)
    at smoke size on the CPU; its step factories are held to the
    reference's by the cached-decode tests."""
    r = cli.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8", "--gen", "6",
                  "--device", "cpu"])
    vocab = registry.get_smoke_config(arch).vocab
    assert r["tokens"].shape == (2, 6) and ((r["tokens"] >= 0) & (r["tokens"] < vocab)).all()
    assert "sample token ids:" in capsys.readouterr().out
