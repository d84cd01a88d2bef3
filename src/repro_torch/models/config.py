"""Model configuration (port of ``repro.models.config``, dense family only).

The reference dataclass covers every family (moe, ssm, hybrid, vlm,
audio); the port so far serves and trains dense decoders, so it keeps the
fields that family reads and refuses the others rather than ignoring them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense only (the other families are not ported yet)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"  # SwiGLU
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.family != "dense":
            raise ValueError(
                f"{self.name}: family {self.family!r} is not ported yet (dense only)"
            )
        if self.act != "silu":
            raise ValueError(f"{self.name}: act {self.act!r} is not ported (silu only)")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads must be a multiple of n_kv_heads")

    @property
    def qk_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def n_params(self) -> int:
        """Analytic total parameter count."""
        d, f, V, hd = self.d_model, self.d_ff, self.vocab, self.head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.qk_dim * d
        return emb + self.n_layers * (attn + 3 * d * f + 2 * d) + d
