"""Synthetic but deterministic LM batches (port of
``repro.data.pipeline``, the token stream).

A batch is keyed only on ``(seed, step)``, so the stream is the same
across restarts.  Tokens mix short repeated motifs from a fixed bank with
25% uniform noise, which gives a model something to learn without an
external dataset.  Draws come from explicit ``torch.Generator``s on the
CPU (a few thousand integers a batch) and the batch is then moved to the
pipeline's device, so the card and the CPU see the same tokens.  torch
draws other numbers than ``jax.random``: the stream has the reference's
shape and mix, not its values.  The reference's checkpointable cursor
(``state_dict``) waits for the checkpointer.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64


NOISE = 0.25  # share of positions replaced by uniform noise


class SyntheticPipeline:
    """Deterministic per-step batch generator; its state is the step."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        self.step = 0
        gen = torch.Generator().manual_seed(dcfg.seed)
        # fixed motif bank (part of the 'dataset', not the per-step state)
        self._motifs = torch.randint(0, cfg.vocab, (dcfg.n_motifs, dcfg.motif_len),
                                     generator=gen)

    def _tokens(self, gen: torch.Generator, B: int, S: int) -> torch.Tensor:
        n_chunks = -(-S // self.dcfg.motif_len)
        ids = torch.randint(0, self.dcfg.n_motifs, (B, n_chunks), generator=gen)
        stream = self._motifs[ids].reshape(B, -1)[:, :S]
        noise = torch.randint(0, self.cfg.vocab, (B, S), generator=gen)
        use_noise = torch.rand((B, S), generator=gen) < NOISE
        return torch.where(use_noise, noise, stream)

    def next_batch(self) -> dict[str, torch.Tensor]:
        """``{"tokens", "labels": [batch, seq_len] int64}``, labels the
        tokens shifted by one."""
        gen = torch.Generator().manual_seed((self.dcfg.seed << 32) + self.step)
        self.step += 1
        toks = self._tokens(gen, self.dcfg.batch, self.dcfg.seq_len + 1).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
