"""Serving workloads (port of ``repro.serving.workloads``).

A workload binds a pool to a request type and gives the engine one
surface: ``admit(request, slot, now)``, ``step(active) -> tokens``,
``collect_tick``, ``output(slot)``, plus the paged hooks ``can_admit`` and
``release``.  Registered (requests carry a token prompt, a generation budget and an EOS
id, and terminate with ``eos_maxlen``):

- ``llm_decode`` — greedy LLM decode over the contiguous
  :class:`~repro_torch.serving.pool.DecodePool`; serves every ported
  config, rolling local windows (gemma3) and the mamba1 state
  (falcon-mamba) included;
- ``llm_decode_paged`` — greedy LLM decode over a
  :class:`~repro_torch.serving.paged.PagedDecodePool` (dense configs
  without a rolling window).

The reference's ``fixedpoint_solve`` workload is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serving.paged import PagedDecodePool
from repro_torch.serving.pool import DecodePool

WORKLOADS: Dict[str, Callable[..., Any]] = {}


def register_workload(name: str):
    def deco(fn):
        WORKLOADS[name] = fn
        return fn

    return deco


def get_workload(name: str) -> Callable[..., Any]:
    try:
        return WORKLOADS[name]
    except KeyError:
        raise ValueError(
            f"unknown workload {name!r}; registered: {sorted(WORKLOADS)}"
        ) from None


def make_workload(name: str, **kwargs):
    return get_workload(name)(**kwargs)


class LLMDecodeWorkload:
    """Continuous greedy decode over a :class:`DecodePool` (subclasses
    build another pool in :meth:`_make_pool`)."""

    default_termination = "eos_maxlen"
    prefill_tokens = 1  # admission's prefill emits the first token

    def __init__(self, *, cfg, slots: int = 8, max_len: int = 64, max_prompt_len: int = 16,
                 params=None, seed: int = 0, device="cuda", **pool_kwargs):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pool = self._make_pool(cfg, slots=slots, max_len=max_len,
                                    max_prompt_len=max_prompt_len, device=self.device,
                                    **pool_kwargs)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = transformer.init_params(cfg, gen, self.device)
        self.params = params
        self.slots = slots
        self._out = [[] for _ in range(slots)]
        self.prefills = 0  # admissions served (one prefill each)

    def _make_pool(self, cfg, **kw):
        return DecodePool(cfg, **kw)

    def _prefill(self, req, slot: int) -> int:
        return self.pool.admit(self.params, req.prompt, slot)

    @property
    def cache_bytes(self) -> int:
        return self.pool.cache_bytes

    def capacity_mask(self) -> np.ndarray:
        """Slots frozen at cache capacity (the engine force-retires active
        ones and counts ``forced_at_capacity``)."""
        return self.pool.capacity_mask()

    def clamp_max_new(self, req) -> int:
        """Generation budget that fits the slot's cache capacity."""
        plen = int(np.asarray(req.prompt).shape[0])
        return max(1, min(int(req.max_new), self.pool.max_len - plen - 1))

    def admit(self, req, slot: int, now: int) -> None:
        self._out[slot] = [self._prefill(req, slot)]
        self.prefills += 1

    def step(self, active: np.ndarray) -> np.ndarray:
        """One decode tick over every active slot -> tokens [S] on the host."""
        return self.pool.step(self.params, active).cpu().numpy()

    def collect_tick(self, tokens: np.ndarray, active: np.ndarray) -> None:
        for s in np.nonzero(active)[0]:
            self._out[s].append(int(tokens[s]))

    def output(self, slot: int) -> np.ndarray:
        return np.asarray(self._out[slot], np.int32)

    def reset(self) -> None:
        """Fresh pool state, same weights (cheap engine re-runs)."""
        self.pool.reset()
        self._out = [[] for _ in range(self.slots)]
        self.prefills = 0


class PagedLLMWorkload(LLMDecodeWorkload):
    """Continuous greedy decode over a :class:`PagedDecodePool`.

    ``can_admit`` is block-budget backpressure (requests wait in the queue
    when the pool is out of blocks) and ``release`` returns a retired
    slot's blocks to the allocator.
    """

    def _make_pool(self, cfg, **kw):
        return PagedDecodePool(cfg, **kw)

    def _prefill(self, req, slot: int) -> int:
        return self.pool.admit(self.params, req.prompt, slot, max_new=self.clamp_max_new(req))

    def can_admit(self, req) -> bool:
        return self.pool.can_admit(np.asarray(req.prompt, np.int32), self.clamp_max_new(req))

    def release(self, slot: int) -> None:
        self.pool.release_slot(slot)

    @property
    def prefix_saved_blocks(self) -> int:
        return self.pool.prefix_saved_blocks


@register_workload("llm_decode")
def llm_decode(**kwargs) -> LLMDecodeWorkload:
    """Contiguous LLM decode over a :class:`DecodePool`."""
    return LLMDecodeWorkload(**kwargs)


@register_workload("llm_decode_paged")
def llm_decode_paged(**kwargs) -> PagedLLMWorkload:
    """Block-paged LLM decode.  Extra kwargs go to :class:`PagedDecodePool`:
    ``block_size``, ``num_blocks`` (default: contiguous-capacity parity),
    ``attn`` ('kernel' | 'gather')."""
    return PagedLLMWorkload(**kwargs)
