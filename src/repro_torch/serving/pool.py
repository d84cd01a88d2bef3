"""The contiguous decode pool (port of ``repro.serving.pool.DecodePool``).

A fixed number of slots over the contiguous decode cache
(``transformer.init_cache``) with per-slot lengths, and slot recycling: a
retired slot is re-used by prefilling the next request into that slot's
cache slice while every other slot keeps decoding.  Unlike the block-paged
pool, it holds rolling local windows (gemma3) and the mamba1 state
(falcon-mamba), which are not paged; the hybrid stack's (zamba2) mamba2
state and shared-block caches sit in the same cache.  ``max_len`` bounds a slot's
sequence in both (the reference's rule), though an SSM's state does not
grow with it.

:class:`FixedPointPool` holds per-request fixed-point solves in the same
kind of slots (the D-iteration serving workload).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.asynchrony.protocols import RES_INIT
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
                 device="cuda", mesh=None):
        if max_prompt_len >= max_len:
            raise ValueError("max_prompt_len must leave room to decode")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh  # a TP world: the cache holds this rank's heads/channels
        self.slots, self.max_len, self.max_prompt_len = slots, max_len, max_prompt_len
        self._pool_step = dserve.make_pool_decode_step(cfg, mesh)
        self._slot_prefill = dserve.make_slot_prefill_step(cfg, max_prompt_len, mesh)
        self.reset()

    def reset(self):
        with dserve.serving_ctx(self.cfg, self.mesh):
            self.cache = transformer.init_cache(self.cfg, self.slots, self.max_len, self.device)
        self.tokens = torch.zeros((self.slots,), dtype=torch.long, device=self.device)
        self.lengths = np.zeros((self.slots,), np.int32)

    @property
    def state(self) -> dict:
        """What a decode tick reads: the cache, the last tokens and the
        host's lengths (the tree a grow broadcasts to a joiner)."""
        return {"cache": self.cache, "tokens": self.tokens, "lengths": self.lengths}

    @state.setter
    def state(self, value: dict) -> None:
        self.cache, self.tokens, self.lengths = value["cache"], value["tokens"], value["lengths"]

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


class FixedPointPool:
    """Per-request fixed-point solves in pool slots.

    Every request shares one operator (``base.full_map``, a
    :class:`~repro_torch.asynchrony.solvers.FixedPoint` on the pool's
    device); a request is its affine payload ``v`` (a personalization
    vector or right-hand side): ``f(x, v) = base(x) + gain * (v - v0)``,
    exact for the linear solvers served (``d_iteration``: ``gain = 1 -
    damping``; weighted Jacobi: ``gain = omega / diag``).  One batched map
    over ``x [S, n]`` advances every active slot a tick; the update
    magnitude is reported per ``dp``-replica block for the agreement.

    Device state: ``x`` and ``payload`` ``[S, n]`` fp32, and the active
    mask, copied to the device only when it changes (admission and
    retirement), so a tick's only wait is its residual's copy to the host.
    """

    def __init__(self, base, *, slots: int, dp: int, gain, payload0=None, device="cuda"):
        if base.n % dp:
            raise ValueError(f"n={base.n} must divide into dp={dp} blocks")
        self.device = resolve_device(device)
        self.base = base.to(self.device)
        self.slots, self.dp, self.n = slots, dp, base.n
        self.gain = torch.as_tensor(np.asarray(gain, np.float32), device=self.device)
        v0 = np.zeros((self.n,), np.float32) if payload0 is None else payload0
        self.v0 = torch.as_tensor(np.asarray(v0, np.float32), device=self.device)
        self.reset()

    def param_map(self, x, v):
        """``f(x, v)`` for ``x, v [..., n]``."""
        return self.base.full_map(x) + self.gain * (v - self.v0)

    @property
    def state(self) -> dict:
        """The iterates and payloads (the tree a grow broadcasts)."""
        return {"x": self.x, "payload": self.payload}

    @state.setter
    def state(self, value: dict) -> None:
        self.x, self.payload = value["x"], value["payload"]

    def reset(self):
        self.x = torch.zeros((self.slots, self.n), device=self.device)
        self.payload = torch.zeros((self.slots, self.n), device=self.device)
        self._active = np.zeros((self.slots,), bool)
        self._active_d = torch.zeros((self.slots,), dtype=torch.bool, device=self.device)

    def step(self, active: np.ndarray) -> torch.Tensor:
        """One iteration of every active slot; returns ``residual [dp, S]``
        on the device: each block's max update magnitude, ``RES_INIT`` for
        an inactive slot (whose iterate is kept)."""
        if not np.array_equal(active, self._active):
            self._active = active.copy()
            self._active_d = torch.from_numpy(self._active).to(self.device)
        act = self._active_d[:, None]
        xnew = self.param_map(self.x, self.payload)
        upd = (xnew - self.x).abs().reshape(self.slots, self.dp, self.n // self.dp).amax(dim=2)
        self.x = torch.where(act, xnew, self.x)
        return torch.where(act, upd, RES_INIT).t()

    def migrate_dp(self, new_dp: int) -> None:
        """Elastic resize: report the residual over ``new_dp`` blocks.  The
        iterates and payloads are the same on every replica, so requests go
        on iterating where they were; only the report's blocks change."""
        if self.n % new_dp:
            raise ValueError(f"n={self.n} must divide into dp={new_dp} blocks")
        self.dp = new_dp

    def admit(self, payload, slot: int) -> None:
        v = np.asarray(payload, np.float32)
        if v.shape != (self.n,):
            raise ValueError(f"payload shape {v.shape} != ({self.n},)")
        self.x[slot] = 0.0
        self.payload[slot] = torch.from_numpy(v).to(self.device)

    def solution(self, slot: int) -> np.ndarray:
        """The slot's iterate, copied (admission zeroes the slot in place)."""
        return self.x[slot].to("cpu", copy=True).numpy()
