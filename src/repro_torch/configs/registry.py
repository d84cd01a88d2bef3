"""Architecture registry (port of ``repro.configs.registry``).

Every arch of the reference is registered: the full config of each and
its reduced smoke config, with the reference's numbers.  The port trains
all of them and serves all but the encoder-only hubert-xlarge, which the
reference never serves either.  Each arch also has a module of its own (``configs/<arch>.py``:
``ARCH``, ``CONFIG``, ``SMOKE``), as in the reference.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

_FULL: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}


def _register(full: ModelConfig, smoke: ModelConfig):
    _FULL[full.name] = full
    _SMOKE[full.name] = smoke


_register(
    # [hf:meta-llama/Llama-3.2-1B]
    ModelConfig(
        name="llama3.2-1b", family="dense", n_layers=16, d_model=2048,
        n_heads=32, n_kv_heads=8, d_ff=8192, vocab=128256,
        head_dim=64, rope_theta=5e5, tie_embeddings=True,
    ),
    ModelConfig(
        name="llama3.2-1b", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
    ),
)

_register(
    # [arXiv:2401.04088] 8 experts top-2, SWA 4096
    ModelConfig(
        name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
        n_experts=8, top_k=2, sliding_window=4096, rope_theta=1e6,
    ),
    ModelConfig(
        name="mixtral-8x7b", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        n_experts=4, top_k=2, sliding_window=32, param_dtype="float32",
        compute_dtype="float32",
    ),
)

_register(
    # [hf:meta-llama/Llama-4-Scout-17B-16E] MoE top-1 (the reference's plain
    # top-1 on every layer: no shared expert, no chunked attention)
    ModelConfig(
        name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
        n_experts=16, top_k=1, rope_theta=5e5,
    ),
    ModelConfig(
        name="llama4-scout-17b-a16e", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
        n_experts=4, top_k=1, param_dtype="float32", compute_dtype="float32",
    ),
)

_register(
    # [arXiv:2404.06395] llama-like
    ModelConfig(
        name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
        n_heads=36, n_kv_heads=36, d_ff=5760, vocab=122880,  # 122753 padded to /256
        head_dim=64, tie_embeddings=True,
    ),
    ModelConfig(
        name="minicpm-2b", family="dense", n_layers=2, d_model=72,
        n_heads=6, n_kv_heads=6, d_ff=144, vocab=256, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
    ),
)


_register(
    # [hf:google/gemma-3-12b] 5:1 local:global, local window 1024
    ModelConfig(
        name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
        n_heads=16, n_kv_heads=8, d_ff=15360, vocab=262144,
        head_dim=256, pattern_local=5, pattern_global=1, local_window=1024,
        rope_theta=1e4, rope_theta_global=1e6, tie_embeddings=True,
    ),
    ModelConfig(
        name="gemma3-12b", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        pattern_local=2, pattern_global=1, local_window=16,
        rope_theta=1e4, rope_theta_global=1e6, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
    ),
)

_register(
    # [hf:Qwen/Qwen2.5-32B] GQA + QKV bias
    ModelConfig(
        name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=27648, vocab=152064,
        qkv_bias=True, rope_theta=1e6,
    ),
    ModelConfig(
        name="qwen2.5-32b", family="dense", n_layers=2, d_model=80,
        n_heads=5, n_kv_heads=1, d_ff=192, vocab=256, qkv_bias=True,
        param_dtype="float32", compute_dtype="float32",
    ),
)

_register(
    # [arXiv:2410.05355] mamba1, attention-free
    ModelConfig(
        name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=65024,
        head_dim=1, ssm_state=16, ssm_version=1, tie_embeddings=True,
    ),
    ModelConfig(
        name="falcon-mamba-7b", family="ssm", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=256,
        head_dim=1, ssm_state=8, ssm_version=1, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
    ),
)

_register(
    # [arXiv:2411.15242] mamba2 + shared attention blocks
    ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
        head_dim=80, ssm_state=64, ssm_version=2, ssm_headdim=64, attn_every=6,
    ),
    ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        head_dim=16, ssm_state=16, ssm_version=2, ssm_headdim=16, attn_every=2,
        param_dtype="float32", compute_dtype="float32",
    ),
)

_register(
    # [arXiv:2404.16821] InternViT frontend (stub) + the language backbone
    ModelConfig(
        name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
        n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151680,  # 151655 padded to /16
        head_dim=64, frontend="vision", n_frontend_tokens=256, rope_theta=1e6,
    ),
    ModelConfig(
        name="internvl2-1b", family="vlm", n_layers=2, d_model=56,
        n_heads=7, n_kv_heads=1, d_ff=112, vocab=256,
        head_dim=8, frontend="vision", n_frontend_tokens=8,
        param_dtype="float32", compute_dtype="float32",
    ),
)

_register(
    # [arXiv:2106.07447] encoder-only; frame embeddings from a stub frontend
    ModelConfig(
        name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
        n_heads=16, n_kv_heads=16, d_ff=5120, vocab=512,  # 504 padded to /16 for TP
        head_dim=80, causal=False, frontend="audio", act="gelu",
    ),
    ModelConfig(
        name="hubert-xlarge", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=64,
        causal=False, frontend="audio", act="gelu",
        param_dtype="float32", compute_dtype="float32",
    ),
)


def get_config(name: str) -> ModelConfig:
    return _FULL[name]


def get_smoke_config(name: str) -> ModelConfig:
    return _SMOKE[name]


def list_archs() -> list[str]:
    return sorted(_FULL)


def override(cfg: ModelConfig, **kw) -> ModelConfig:
    return dataclasses.replace(cfg, **kw)
