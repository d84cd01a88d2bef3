"""Architecture registry (port of ``repro.configs.registry``).

Only the archs the port can serve and train are registered: the full
config of each and its reduced smoke config, with the reference's numbers.
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


def get_config(name: str) -> ModelConfig:
    return _FULL[name]


def get_smoke_config(name: str) -> ModelConfig:
    return _SMOKE[name]


def list_archs() -> list[str]:
    return sorted(_FULL)


def override(cfg: ModelConfig, **kw) -> ModelConfig:
    return dataclasses.replace(cfg, **kw)
