"""Serving workloads (port of ``repro.serving.workloads``).

A workload binds a pool to a request type and gives the engine one
surface: ``admit(request, slot, now)``, ``step(active) -> (tokens,
residual)``, ``collect_tick``, ``output(slot)``, plus the paged hooks
``can_admit`` and ``release``; ``sample_request(tenant, rng, id=,
arrival=)`` draws one request of a tenant of the traffic model
(``serving/tenants.py``).  For elastic resize, ``wstate`` is the pool's
state that a grow broadcasts to a joiner and installs again (the paged
pool's carries its host side, the allocator and the block lists, under
``host``), and a
fixed-point workload's ``migrate_dp`` re-blocks its residual report at a
new extent.  Registered:

- ``llm_decode`` — greedy LLM decode over the contiguous
  :class:`~repro_torch.serving.pool.DecodePool`; serves every ported
  config, rolling local windows (gemma3), the mamba1 state (falcon-mamba)
  and the hybrid stack (zamba2) included;
- ``llm_decode_paged`` — greedy LLM decode over a
  :class:`~repro_torch.serving.paged.PagedDecodePool` (dense configs
  without a rolling window, and the hybrid stack: its shared-block caches
  paged, its mamba2 state per slot);
- ``fixedpoint_solve`` — per-request fixed-point solves over a
  :class:`~repro_torch.serving.pool.FixedPointPool`, from the
  ``repro_torch.asynchrony`` solvers whose parameter enters affinely
  (``d_iteration``: personalized PageRank-style damped diffusion;
  ``poisson1d`` and ``jacobi_dense``: weighted Jacobi).

LLM requests carry a token prompt, a generation budget and an EOS id, and
terminate with ``eos_maxlen``; fixed-point requests carry an affine
payload (a personalization vector or right-hand side) and an iteration
budget, and terminate with ``residual_interval`` or ``residual_inexact``,
the paper's detection protocols certifying each request's convergence.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.asynchrony.solvers import make_solver, random_dd_system
from repro_torch.device import resolve_device
from repro_torch.distributed import serve as dserve
from repro_torch.models import transformer
from repro_torch.serving.engine import Request
from repro_torch.serving.paged import PagedDecodePool
from repro_torch.serving.pool import DecodePool, FixedPointPool

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

    residual_capable = False
    default_termination = "eos_maxlen"
    prefill_tokens = 1  # admission's prefill emits the first token

    def __init__(self, *, cfg, slots: int = 8, max_len: int = 64, max_prompt_len: int = 16,
                 params=None, seed: int = 0, device="cuda", mesh=None, **pool_kwargs):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pool = self._make_pool(cfg, slots=slots, max_len=max_len,
                                    max_prompt_len=max_prompt_len, device=self.device,
                                    mesh=mesh, **pool_kwargs)
        # in a TP world (``mesh``) each rank keeps its blocks of the weights;
        # every rank's engine then makes the same decisions
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = transformer.init_params(cfg, gen, self.device,
                                             place=dserve.param_placer(cfg, mesh))
        self.params = params
        self.slots = slots
        self._out = [[] for _ in range(slots)]
        self.prefills = 0  # admissions served (one prefill each)

    def _make_pool(self, cfg, **kw):
        return DecodePool(cfg, **kw)

    def _prefill(self, req, slot: int) -> int:
        return self.pool.admit(self.params, req.prompt, slot)

    @property
    def wstate(self) -> dict:
        """The pool's state a decode tick reads (the contiguous cache or the
        pages and tables, the slot state, the last tokens)."""
        return self.pool.state

    @wstate.setter
    def wstate(self, value: dict) -> None:
        self.pool.state = value

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

    def sample_request(self, tenant, rng, *, id: int, arrival: int) -> Request:
        """One seeded request of ``tenant``: a prompt length in [1,
        tenant.prompt_len] within the pool's prompt length, a budget in
        [hi // 2, hi] for hi the tenant's within the cache's room."""
        plen = int(rng.integers(1, max(1, min(tenant.prompt_len, self.pool.max_prompt_len)) + 1))
        hi = max(1, min(tenant.max_new, self.pool.max_len - plen - 1))
        lo = max(1, hi // 2)
        return Request(id=id, arrival=arrival,
                       prompt=rng.integers(0, self.cfg.vocab, size=plen).astype(np.int32),
                       max_new=int(rng.integers(lo, hi + 1)), eos=-1, priority=tenant.priority,
                       sla=tenant.sla, tenant=tenant.name)

    def admit(self, req, slot: int, now: int) -> None:
        self._out[slot] = [self._prefill(req, slot)]
        self.prefills += 1

    def step(self, active: np.ndarray):
        """One decode tick over every active slot -> (tokens [S] on the
        host, None: no residual)."""
        return self.pool.step(self.params, active).cpu().numpy(), None

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

    # the pool's host side alone (a grow sends it inside ``wstate``)
    def export_state(self):
        return self.pool.export_state()

    def import_state(self, st) -> None:
        self.pool.import_state(st)


class FixedPointWorkload:
    """Per-request fixed-point solves over a :class:`FixedPointPool`."""

    residual_capable = True
    default_termination = "residual_interval"
    prefill_tokens = 0  # admission performs no iteration

    def __init__(self, base, gain, payload0, *, slots: int, dp: int, device="cuda"):
        self.pool = FixedPointPool(base, slots=slots, dp=dp, gain=gain, payload0=payload0,
                                   device=device)
        self.device = self.pool.device
        self.base = self.pool.base
        self.payload0 = np.asarray(payload0, np.float32)
        self.slots, self.dp = slots, dp
        self._tokens = np.zeros((slots,), np.int64)

    @property
    def wstate(self) -> dict:
        return self.pool.state

    @wstate.setter
    def wstate(self, value: dict) -> None:
        self.pool.state = value

    def dp_refusal(self, new_dp: int) -> Optional[str]:
        """Why :meth:`migrate_dp` cannot take ``new_dp`` (the residual's
        blocks must split ``n`` evenly), or None."""
        n = self.pool.n
        return None if n % new_dp == 0 else f"n={n} must divide into dp={new_dp} blocks"

    def migrate_dp(self, new_dp: int) -> None:
        """Elastic resize: the iterates stay as they are; only the pool's
        residual report is re-blocked at the new extent."""
        self.pool.migrate_dp(new_dp)
        self.dp = new_dp

    def clamp_max_new(self, req) -> int:
        return int(req.max_new)

    def sample_request(self, tenant, rng, *, id: int, arrival: int) -> Request:
        """One seeded request of ``tenant``: a random payload scaled to
        ``payload0``'s mass, so eps thresholds carry over."""
        v = rng.random(self.payload0.shape[0]).astype(np.float32)
        scale = float(np.abs(self.payload0).sum()) or 1.0
        return Request(id=id, arrival=arrival, payload=v * (scale / max(float(v.sum()), 1e-9)),
                       max_new=tenant.max_new, priority=tenant.priority, sla=tenant.sla,
                       eps=tenant.eps, tenant=tenant.name)

    def admit(self, req, slot: int, now: int) -> None:
        self.pool.admit(self.payload0 if req.payload is None else req.payload, slot)

    def step(self, active: np.ndarray):
        """One iteration of every active slot -> (zero tokens [S], residual
        [dp, S] fp32), both on the host (the residual's copy is the tick's
        one wait on the device)."""
        return self._tokens, self.pool.step(active).cpu().numpy()

    def collect_tick(self, tokens: np.ndarray, active: np.ndarray) -> None:
        pass  # outputs are read from the pool at retirement

    def output(self, slot: int) -> np.ndarray:
        return self.pool.solution(slot)

    def reset(self) -> None:
        self.pool.reset()

    def true_residual(self, slot: int, payload) -> float:
        """``||f(x) - x||_inf`` of the slot's iterate under its own payload
        (on the pool's device): what a certification must bound."""
        x = self.pool.x[slot]
        v = torch.from_numpy(self.payload0 if payload is None
                             else np.asarray(payload, np.float32)).to(self.device)
        return float((self.pool.param_map(x, v) - x).abs().amax())


@register_workload("llm_decode")
def llm_decode(**kwargs) -> LLMDecodeWorkload:
    """Contiguous LLM decode over a :class:`DecodePool`."""
    return LLMDecodeWorkload(**kwargs)


@register_workload("llm_decode_paged")
def llm_decode_paged(**kwargs) -> PagedLLMWorkload:
    """Block-paged LLM decode.  Extra kwargs go to :class:`PagedDecodePool`:
    ``block_size``, ``num_blocks`` (default: contiguous-capacity parity),
    ``share_prefixes``, ``attn`` ('kernel' | 'gather'; an int8 cache takes
    'gather')."""
    return PagedLLMWorkload(**kwargs)


@register_workload("fixedpoint_solve")
def fixedpoint_solve(*, solver: str = "d_iteration", slots: int = 8, dp: int = 1, n: int = 64,
                     device="cuda", **solver_kwargs) -> FixedPointWorkload:
    """The fixed-point serving workload from a solver whose parameter
    enters affinely with a known gain:

    - ``d_iteration`` (``damping``, ``out_degree``, ``seed``, ``v``):
      ``gain = 1 - damping``, default payload ``v0 = 1/n``;
    - ``poisson1d`` (``omega``, ``shift``, ``rhs``, ``seed``,
      ``rhs_scale``): ``gain = omega / (2 + shift)``, the payload a
      right-hand side.  Without ``rhs=`` the default one is drawn from the
      port's counter-based source (``U[-rhs_scale, rhs_scale]``), not the
      reference's ``jax.random`` draw: pass ``rhs=`` for the reference's;
    - ``jacobi_dense`` (``omega``, ``seed``, ``dominance``): the random
      diagonally dominant system of ``random_dd_system``, ``gain = omega /
      diag(A)``.
    """
    if solver == "d_iteration":
        damping = float(solver_kwargs.pop("damping", 0.85))
        v0 = solver_kwargs.pop("v", None)
        if v0 is None:
            v0 = np.full((n,), 1.0 / n, np.float32)
        base = make_solver("d_iteration", n=n, damping=damping, v=v0, **solver_kwargs)
        gain = 1.0 - damping
        payload0 = v0
    elif solver == "poisson1d":
        omega = float(solver_kwargs.pop("omega", 1.0))
        shift = float(solver_kwargs.pop("shift", 0.0))
        base = make_solver("poisson1d", n=n, omega=omega, shift=shift, **solver_kwargs)
        gain = omega / (2.0 + shift)
        payload0 = base.data["rhs"].numpy()
    elif solver == "jacobi_dense":
        omega = float(solver_kwargs.pop("omega", 1.0))
        seed = int(solver_kwargs.pop("seed", 0))
        dominance = float(solver_kwargs.pop("dominance", 2.0))
        A, b = random_dd_system(n, seed=seed, dominance=dominance)
        A, b = A.astype(np.float32), b.astype(np.float32)
        base = make_solver("jacobi_dense", A=A, b=b, omega=omega)
        gain = omega / np.diag(A)
        payload0 = b
    else:
        raise ValueError(
            "fixedpoint_solve serves affine-payload solvers "
            f"(d_iteration | poisson1d | jacobi_dense), got {solver!r}"
        )
    return FixedPointWorkload(base, gain, payload0, slots=slots, dp=dp, device=device)
