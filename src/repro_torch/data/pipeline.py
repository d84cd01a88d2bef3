"""Synthetic but deterministic LM batches (port of
``repro.data.pipeline``): the token stream, and the frontends' stub
inputs (vision patches; audio frames with per-frame labels).

A batch is keyed only on ``(seed, step)``, so the stream is the same
across restarts, and the pipeline's state is its step: the checkpointable
cursor (:meth:`SyntheticPipeline.state_dict`) that a resumed run loads.  Tokens mix short repeated motifs from a fixed bank with
25% uniform noise, which gives a model something to learn without an
external dataset.  Draws come from explicit ``torch.Generator``s on the
CPU (a few thousand integers a batch; the frontends' inputs are normal
draws of [B, P, 1024] or [B, S, 80]) and the batch is then moved to the
pipeline's device, so the card and the CPU see the same batches.  torch
draws other numbers than ``jax.random``: the stream has the reference's
shape and mix, not its values.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import audio_frames, vision_patches


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64


NOISE = 0.25  # share of positions replaced by uniform noise


class SyntheticPipeline:
    """Deterministic per-step batch generator; its state is the step.

    In a world of ``dp`` ranks (one process a rank) every rank draws the
    global batch and keeps its contiguous ``batch / dp`` slice ``rank``,
    the sequences a stacked-rows trainer gives that rank's row."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, device="cuda", *, rank: int = 0,
                 dp: int = 1):
        if dcfg.batch % dp:
            raise ValueError(f"batch {dcfg.batch} does not split over dp={dp} ranks")
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        self.rank, self.dp = rank, dp
        self.step = 0
        gen = torch.Generator().manual_seed(dcfg.seed)
        # fixed motif bank (part of the 'dataset', not the per-step state)
        self._motifs = torch.randint(0, cfg.vocab, (dcfg.n_motifs, dcfg.motif_len),
                                     generator=gen)

    # --- checkpointable state ---
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.dcfg.seed}

    def load_state_dict(self, st: dict) -> None:
        if st["seed"] != self.dcfg.seed:
            raise ValueError(f"data seed mismatch on restore: the checkpoint's stream is seed "
                             f"{st['seed']}, this pipeline's {self.dcfg.seed}")
        self.step = int(st["step"])

    def _tokens(self, gen: torch.Generator, B: int, S: int) -> torch.Tensor:
        n_chunks = -(-S // self.dcfg.motif_len)
        ids = torch.randint(0, self.dcfg.n_motifs, (B, n_chunks), generator=gen)
        stream = self._motifs[ids].reshape(B, -1)[:, :S]
        noise = torch.randint(0, self.cfg.vocab, (B, S), generator=gen)
        use_noise = torch.rand((B, S), generator=gen) < NOISE
        return torch.where(use_noise, noise, stream)

    def next_batch(self) -> dict[str, torch.Tensor]:
        """``{"tokens", "labels": [batch, seq_len] int64}``, labels the
        tokens shifted by one; with the vision frontend also ``patches``
        [batch, n_frontend_tokens, 1024] in the compute type (bf16, or fp32
        for an fp32 config); for the audio encoder ``{"frames": [batch,
        seq_len, 80] fp32, "labels": [batch, seq_len] int64}`` instead, a
        uniform label a frame, as the reference's.  In a world: this rank's
        ``batch / dp`` rows of each."""
        gen = torch.Generator().manual_seed((self.dcfg.seed << 32) + self.step)
        self.step += 1
        B, S = self.dcfg.batch, self.dcfg.seq_len
        toks = self._tokens(gen, B, S + 1)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend == "vision":
            dt = torch.float32 if self.cfg.compute_dtype == "float32" else torch.bfloat16
            batch["patches"] = vision_patches(gen, B, self.cfg.n_frontend_tokens, dt)
        elif self.cfg.frontend == "audio":
            frames = audio_frames(gen, B, S, torch.float32)
            batch = {"frames": frames,
                     "labels": torch.randint(0, self.cfg.vocab, (B, S), generator=gen)}
        per = B // self.dp
        return {k: v[self.rank * per:(self.rank + 1) * per].to(self.device)
                for k, v in batch.items()}
