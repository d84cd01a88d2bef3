"""AdamW, Lion and SGD with cosine, WSD and constant learning-rate
schedules (port of ``repro.optim.optimizer``): the vector form on flat
fp32 shards, which the ZeRO-1 gradient syncs run, and the tree form, fp32
``master``/``mu``/``nu`` trees shaped like the params, which ``mrd_leaf``
and ``local_sgd`` run.  Every optimizer keeps the same three fp32 leaves,
so the checkpoint layout is one: Lion leaves ``nu`` untouched, SGD both
moments.

The scalar arithmetic (learning rate, bias corrections) runs in float32,
as the reference's does on its int32 step counter.  Divisors are tensors:
PyTorch's CUDA division by a Python number multiplies by its reciprocal,
which can differ from true division in the last bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # 'adamw' | 'lion' | 'sgd'
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"  # 'cosine' | 'wsd' | 'const'
    warmup_steps: int = 100
    total_steps: int = 10000
    wsd_decay_frac: float = 0.1  # minicpm's WSD: final decay fraction


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule_lr(ocfg: OptimizerConfig, step) -> float:
    """Learning rate at ``step`` (an int), computed in float32."""
    step = _f32(step)
    if ocfg.warmup_steps <= 0:
        warm = _f32(1.0)
    else:
        warm = torch.clamp(step / _f32(ocfg.warmup_steps), max=1.0)
    lr = _f32(ocfg.lr)
    if ocfg.schedule == "const":
        return float(lr * warm)
    total = float(max(ocfg.total_steps, 1))
    if ocfg.schedule == "cosine":
        t = torch.clamp((step - ocfg.warmup_steps) / _f32(max(total - ocfg.warmup_steps, 1)), 0, 1)
        return float(lr * warm * 0.5 * (1 + torch.cos(_f32(math.pi) * t)))
    if ocfg.schedule == "wsd":  # warmup -> stable -> linear decay tail
        decay_start = total * (1 - ocfg.wsd_decay_frac)
        tail = torch.clamp((step - decay_start) / _f32(max(total - decay_start, 1)), 0, 1)
        return float(lr * warm * (1 - tail))
    raise ValueError(ocfg.schedule)


def init_opt_state(params) -> dict:
    """Tree form: fp32 ``master`` copies of ``params`` (a nested dict of
    tensors) and zero ``mu``/``nu`` trees of the same shapes."""
    def tree(fn, t):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in t.items()}

    return {"master": tree(lambda p: p.to(torch.float32, copy=True), params),
            "mu": tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "nu": tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}


UPDATE_CHUNK = 1 << 26  # elements of a leaf one pass of the tree update takes


def apply_update_tree_(grads: list, opt: dict[str, list], ocfg: OptimizerConfig, step,
                       param_dtype) -> list:
    """Tree form of :func:`apply_update_vector`, leaf by leaf: ``grads``
    and each of ``opt["master"]``/``["mu"]``/``["nu"]`` are lists of
    matching leaves (fp32 optimizer leaves, contiguous, updated in place).
    Returns the new params, each master leaf cast to ``param_dtype``.  A
    leaf is updated ``UPDATE_CHUNK`` elements at a time (the update is
    elementwise), so its fp32 temporaries are a chunk's, not the leaf's
    (falcon-mamba-7b's in_proj: 4.3 GB a temporary at dp 4)."""
    out = []
    for i, g in enumerate(grads):
        flat = {k: opt[k][i].view(-1) for k in ("master", "mu", "nu")}
        g = g.reshape(-1)
        new_p = torch.empty(opt["master"][i].shape, dtype=param_dtype, device=g.device)
        for a in range(0, g.numel(), UPDATE_CHUNK):
            part = {k: v[a:a + UPDATE_CHUNK] for k, v in flat.items()}
            _, new = apply_update_vector(g[a:a + UPDATE_CHUNK].float(), part, ocfg, step)
            for k, v in part.items():
                if new[k] is not v:  # a moment the optimizer leaves as it is
                    v.copy_(new[k])
            new_p.view(-1)[a:a + UPDATE_CHUNK].copy_(part["master"])
        out.append(new_p)
    return out


def init_opt_vector(n: int, device="cpu") -> dict[str, torch.Tensor]:
    return {k: torch.zeros((n,), dtype=torch.float32, device=device)
            for k in ("master", "mu", "nu")}


def apply_update_vector(g, opt, ocfg: OptimizerConfig, step):
    """The optimizer ``ocfg.name`` on g: fp32 [n] gradient shard; opt:
    ``master``/``mu``/``nu`` [n] fp32; step: int.  Returns (new_master
    [n], new_opt); a moment the optimizer does not use is passed through."""
    lr = schedule_lr(ocfg, step)
    m, mu, nu = opt["master"], opt["mu"], opt["nu"]
    if ocfg.name == "sgd":
        new_m = m - lr * (g + ocfg.weight_decay * m)
        return new_m, {"master": new_m, "mu": mu, "nu": nu}
    if ocfg.name == "lion":
        u = torch.sign(ocfg.beta1 * mu + (1 - ocfg.beta1) * g)
        new_mu = ocfg.beta2 * mu + (1 - ocfg.beta2) * g
        new_m = m - lr * (u + ocfg.weight_decay * m)
        return new_m, {"master": new_m, "mu": new_mu, "nu": nu}
    if ocfg.name != "adamw":
        raise ValueError(f"unknown optimizer {ocfg.name!r}; known: adamw, lion, sgd")
    t = _f32(step + 1)
    bc1 = (1 - _f32(ocfg.beta1) ** t).to(g.device)
    bc2 = (1 - _f32(ocfg.beta2) ** t).to(g.device)
    new_mu = ocfg.beta1 * mu + (1 - ocfg.beta1) * g
    new_nu = ocfg.beta2 * nu + (1 - ocfg.beta2) * g * g
    mu_hat = new_mu / bc1
    nu_hat = new_nu / bc2
    new_m = m - lr * (mu_hat / (torch.sqrt(nu_hat) + ocfg.eps) + ocfg.weight_decay * m)
    return new_m, {"master": new_m, "mu": new_mu, "nu": new_nu}
