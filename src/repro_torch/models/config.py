"""Model configuration (port of ``repro.models.config``: every family of
the reference, dense, moe, vlm, mamba1 ``ssm``, mamba2 ``hybrid`` and the
``audio`` encoder).

The port trains every family and serves all but the encoder-only audio
one (hubert, whose reference never serves it either): dense decoders,
including the grouped local/global stack of gemma3, the moe stack
(mixtral, llama4-scout), the vlm backbone (internvl2, its vision frontend
a stub), the attention-free mamba1 stack of falcon-mamba, the hybrid
stack of zamba2 (groups of mamba2 layers, each followed by one
weight-shared attention block) and the bidirectional audio stack of
hubert (its conv frontend a stub, a two-matrix gelu MLP).  It keeps the
fields those families read and refuses combinations the reference does
not run (mamba2 outside the hybrid family, int8 caches outside the plain
stack) rather than ignoring them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


ATTN_IMPLS = ("auto", "full", "flash_scan", "kernel")
KV_CACHE_DTYPES = ("bf16", "int8")
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
# the plain attention stack (and gemma3's grouped one); audio's is the same
# stack, bidirectional, and never served
ATTN_FAMILIES = ("dense", "moe", "vlm")
FRONTENDS = (None, "vision", "audio")
ACTS = ("silu", "gelu")  # SwiGLU, or the two-matrix MLP with tanh-approximated gelu


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | ssm (mamba1) | hybrid (mamba2) | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    rope_theta: float = 10000.0
    rope_theta_global: Optional[float] = None  # gemma3 global layers (1M)
    qkv_bias: bool = False  # qwen2.5: biases on the q/k/v projections
    sliding_window: Optional[int] = None  # window on every attention layer
    local_window: Optional[int] = None  # gemma3 local layers
    pattern_local: int = 0  # gemma3: local layers per group
    pattern_global: int = 0  # gemma3: global layers per group
    causal: bool = True  # False: an encoder-only stack (hubert)
    n_experts: int = 0  # moe
    top_k: int = 0
    capacity_factor: float = 1.25
    ssm_state: int = 0  # ssm (mamba1) and hybrid (mamba2)
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1  # 1 = mamba1 (ssm), 2 = mamba2 (hybrid only)
    ssm_headdim: int = 64  # mamba2
    attn_every: int = 0  # hybrid: the shared attention block after every k mamba2 layers
    ssm_chunk: int = 256  # mamba2: the SSD scan's chunk length
    # modality frontend (a stub: precomputed patch embeddings are inputs)
    frontend: Optional[str] = None  # 'vision' | 'audio'
    n_frontend_tokens: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"  # 'silu': SwiGLU; 'gelu': w2(gelu(x w1))
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "auto"  # auto | full | flash_scan | kernel (the reference's pallas)
    attn_chunk: int = 1024  # flash_scan tile length
    moe_seq_chunk: int = 8192  # a full-sequence forward routes chunks of this length
    # 'bf16': the cache in the compute type; 'int8': int8 rows with an fp32
    # scale per (token, head), the plain stack only
    kv_cache_dtype: str = "bf16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"{self.name}: kv_cache_dtype {self.kv_cache_dtype!r} not in "
                             f"{KV_CACHE_DTYPES}")
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: unknown family {self.family!r} (one of "
                             f"{', '.join(FAMILIES)})")
        if self.kv_cache_dtype == "int8" and (self.family not in ATTN_FAMILIES
                                              or self.pattern_local):
            # the reference has scale planes only for the plain stack's k/v
            raise ValueError(f"{self.name}: an int8 KV cache needs the plain dense/moe/vlm "
                             "stack (the grouped stack and the ssm and hybrid families have no "
                             "scale planes)")
        if self.family == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError(f"{self.name}: moe family needs experts/top_k")
        if self.frontend not in FRONTENDS:
            raise ValueError(f"{self.name}: frontend {self.frontend!r} not in {FRONTENDS}")
        if self.family in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError(f"{self.name}: ssm family needs ssm_state > 0")
        if self.family == "ssm":
            if self.ssm_version != 1:
                raise ValueError(f"{self.name}: mamba{self.ssm_version} is not ported outside "
                                 "the hybrid family (mamba1 only)")
            return
        if self.family == "hybrid":
            if self.ssm_version != 2:
                raise ValueError(f"{self.name}: the hybrid family is mamba2 (ssm_version=2)")
            if self.attn_every <= 0 or self.n_layers % self.attn_every:
                raise ValueError(f"{self.name}: a hybrid stack needs attn_every > 0 dividing "
                                 f"n_layers, got {self.attn_every} and {self.n_layers}")
            if self.d_inner % self.ssm_headdim:
                raise ValueError(f"{self.name}: d_inner {self.d_inner} is not a multiple of "
                                 f"ssm_headdim {self.ssm_headdim}")
        if self.act not in ACTS:
            raise ValueError(f"{self.name}: act {self.act!r} not in {ACTS}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads must be a multiple of n_kv_heads")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"{self.name}: attn_impl {self.attn_impl!r} not in {ATTN_IMPLS}")
        if self.pattern_local:
            # the reference stacks one global layer per group ([G, ...] leaves)
            if self.pattern_global != 1 or self.n_layers % (self.pattern_local + 1):
                raise ValueError(
                    f"{self.name}: a grouped stack needs pattern_global == 1 and n_layers "
                    f"divisible by pattern_local + 1"
                )
            if self.sliding_window is not None:
                raise ValueError(f"{self.name}: a grouped stack windows its local layers "
                                 "(local_window), not every layer")

    @property
    def n_groups(self) -> int:
        """Groups of (pattern_local local + 1 global) layers, or of attn_every
        mamba2 layers (hybrid); 0 for a plain stack."""
        if self.family == "hybrid":
            return self.n_layers // self.attn_every
        return self.n_layers // (self.pattern_local + 1) if self.pattern_local else 0

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def qk_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, -(-self.d_model // 16))  # ceil(d/16), mamba1 default

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim  # mamba2

    def n_params(self) -> int:
        """Analytic total parameter count (the reference's: it leaves out
        the qkv biases and the frontends' ``patch_proj``/``frame_proj``)."""
        d, f, V, hd = self.d_model, self.d_ff, self.vocab, self.head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # the reference's count, which leaves out dt_bias [di]
            di, st, dtr = self.d_inner, self.ssm_state, self.dt_rank
            per = (
                d * 2 * di + self.ssm_conv * di + di
                + di * (dtr + 2 * st) + dtr * di + di * st + di
                + di * d + d
            )
            return emb + self.n_layers * per + d
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.qk_dim * d
        if self.family == "hybrid":
            # the reference's count, which leaves out each layer's conv_b
            # [di + 2 N] and two of its three [nh] vectors (D, dt_bias)
            di, st, nh = self.d_inner, self.ssm_state, self.ssm_nheads
            per = (d * (2 * di + 2 * st + nh) + self.ssm_conv * (di + 2 * st)
                   + nh + di + di * d + d)
            return emb + self.n_layers * per + d + attn + 3 * d * f + 2 * d
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            mlp = (3 if self.act == "silu" else 2) * d * f
        return emb + self.n_layers * (attn + mlp + 2 * d) + d

    def n_active_params(self) -> int:
        """Parameters a token reads (moe: only its top_k experts count)."""
        if self.family != "moe":
            return self.n_params()
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff
        return self.n_params() - inactive
