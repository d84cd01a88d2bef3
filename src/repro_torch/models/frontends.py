"""Modality frontend stubs (port of ``repro.models.frontends``).

The vlm and audio configs specify the transformer backbone only; the
frontend's output is a model input of fixed width (precomputed patch or
frame embeddings).  These draw synthetic inputs of those shapes from an
explicit ``torch.Generator`` (the reference draws from a JAX key: the
distributions are the same, the numbers are not).  The backbone projects
them with ``patch_proj`` [1024, d] and prepends them to the token
embeddings; the audio encoder projects its frames with ``frame_proj``
[80, d] and takes no tokens.
"""

from __future__ import annotations

import torch

VISION_EMBED_DIM = 1024  # InternViT output width (projected to d_model)
AUDIO_FEAT_DIM = 80  # log-mel-like frame features


def vision_patches(gen: torch.Generator, batch: int, n_patches: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Stub InternViT: patch embeddings [B, P, 1024] ~ N(0, 1) on ``gen``'s
    device."""
    x = torch.randn((batch, n_patches, VISION_EMBED_DIM), generator=gen, device=gen.device)
    return x.to(dtype)


def audio_frames(gen: torch.Generator, batch: int, n_frames: int,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Stub wav2vec2-style conv frontend: frame features [B, T, 80] ~ N(0, 1)
    on ``gen``'s device."""
    x = torch.randn((batch, n_frames, AUDIO_FEAT_DIM), generator=gen, device=gen.device)
    return x.to(dtype)
