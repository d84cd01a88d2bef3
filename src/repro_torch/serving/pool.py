"""The contiguous decode pool (port of ``repro.serving.pool.DecodePool``).

A fixed number of slots over the contiguous decode cache
(``transformer.init_cache``) with per-slot lengths, and slot recycling: a
retired slot is re-used by prefilling the next request into that slot's
cache slice while every other slot keeps decoding.  Unlike the block-paged
pool, it holds rolling local windows (gemma3) and the mamba1 state
(falcon-mamba), which are not paged.  ``max_len`` bounds a slot's
sequence in both (the reference's rule), though an SSM's state does not
grow with it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import serve as dserve
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


class DecodePool:
    """Fixed-slot continuous-batching pool over one device.

    Device state: the cache and the last token of each slot.  Host state:
    the per-slot ``lengths`` (the host advances them, so reading them never
    waits on the device).
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, max_len: int, max_prompt_len: int,
                 device="cuda"):
        if max_prompt_len >= max_len:
            raise ValueError("max_prompt_len must leave room to decode")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots, self.max_len, self.max_prompt_len = slots, max_len, max_prompt_len
        self._pool_step = dserve.make_pool_decode_step(cfg)
        self._slot_prefill = dserve.make_slot_prefill_step(cfg, max_prompt_len)
        self.reset()

    def reset(self):
        self.cache = transformer.init_cache(self.cfg, self.slots, self.max_len, self.device)
        self.tokens = torch.zeros((self.slots,), dtype=torch.long, device=self.device)
        self.lengths = np.zeros((self.slots,), np.int32)

    def step(self, params, active: np.ndarray) -> torch.Tensor:
        """Advance every active slot one token; returns the tokens [S] (on
        the device; inactive slots keep their last token and their cache)."""
        active_d = torch.from_numpy(active).to(self.device)
        lengths_d = torch.from_numpy(self.lengths).to(self.device)
        logits = self._pool_step(params, self.tokens, self.cache, lengths_d, active_d)
        self.tokens = torch.where(active_d, torch.argmax(logits, dim=-1), self.tokens)
        # freeze at the cache capacity (the engine retires such slots; the
        # clamp keeps the write inside the cache meanwhile)
        adv = active & (self.lengths < self.max_len - 1)
        self.lengths = np.where(adv, self.lengths + 1, self.lengths).astype(np.int32)
        return self.tokens

    def capacity_mask(self) -> np.ndarray:
        """Slots frozen at the cache capacity clamp."""
        return self.lengths >= self.max_len - 1

    @property
    def cache_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self.cache.values()))

    def admit(self, params, prompt, slot: int) -> int:
        """Prefill ``prompt`` (1-D int array) into ``slot``; returns the
        request's first token (greedy argmax of the last position)."""
        prompt = np.asarray(prompt, np.int32)
        last_logits = self._slot_prefill(
            params, torch.from_numpy(prompt).long().to(self.device), self.cache, slot)
        tok0 = torch.argmax(last_logits)
        self.tokens[slot] = tok0
        self.lengths[slot] = prompt.shape[0]
        return int(tok0)
