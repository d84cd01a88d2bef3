"""Fixed-point solvers (port of ``repro.asynchrony.solvers``, ``SOLVERS``).

The paper's setting: ``Ax = b``, splitting ``A = M - N``, iteration
``x <- Tx + c``.  The engine (``repro_torch.asynchrony.engine``) needs only
the fixed-point map ``f`` and a block partitioning; every solver is a
registered factory ``SOLVERS[name](**kwargs) -> FixedPoint``:

- ``poisson1d``: the paper's S4 experiment (1-D two-point BVP, finite
  differences, weighted Jacobi);
- ``poisson2d``: the 5-point Laplacian on an ``nx x ny`` grid;
- ``jacobi_dense`` / ``richardson``: dense variants for tests (a random
  strictly diagonally dominant system by default);
- ``d_iteration``: the damped-diffusion fixed point of the D-iteration
  family (arXiv:1301.3007), contraction factor = the damping.

A :class:`FixedPoint` keeps its data (right-hand side, matrix) as tensors
in ``data`` and its map as a function of ``(data, x)``, so
:meth:`FixedPoint.to` moves a problem to the device a run uses.  Every
map takes ``x [..., n]`` with any leading batch dimensions, and keeps the
reference's order of operations (one op at a time, no fused alpha), so
the elementwise solvers match it bit for bit.

Where the reference draws a right-hand side with ``jax.random``, the port
takes it as ``rhs=``; without one it draws from the engine's
counter-based source (the same bits on the CPU and the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.asynchrony.draws import uniform_table


@dataclasses.dataclass(frozen=True)
class FixedPoint:
    """A fixed-point problem ``f(x) = x`` partitioned into p equal blocks.

    ``map_fn(data, x)`` is ``f`` on ``x [..., n]``; ``contraction`` is an
    upper bound on rho(|T|) where the constructor knows one."""

    n: int
    map_fn: Callable
    data: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    name: str = "fixed-point"
    contraction: Optional[float] = None

    def full_map(self, x):
        return self.map_fn(self.data, x)

    def to(self, device) -> "FixedPoint":
        return dataclasses.replace(self, data={k: v.to(device) for k, v in self.data.items()})

    def residual_norm(self, x):
        """``||f(x) - x||_inf`` over the last axis: the paper's termination
        functional."""
        return (self.full_map(x) - x).abs().amax(dim=-1)

    def block_views_update(self, views):
        """``views [..., p, n]``: worker i's possibly-stale global view.
        Returns ``[..., p, m]``: worker i's new block, ``f(view_i)``
        restricted to block i (``f`` of each whole view, as the reference)."""
        p = views.shape[-2]
        full = self.full_map(views)
        blocks = full.reshape(full.shape[:-1] + (p, self.n // p))  # [..., p, p, m]
        return torch.diagonal(blocks, dim1=-3, dim2=-2).movedim(-1, -2)


SOLVERS: Dict[str, Callable[..., FixedPoint]] = {}


def register_solver(name: str):
    """Decorator: register a ``(**kwargs) -> FixedPoint`` factory."""

    def deco(fn):
        SOLVERS[name] = fn
        return fn

    return deco


def get_solver(name: str) -> Callable[..., FixedPoint]:
    try:
        return SOLVERS[name]
    except KeyError:
        raise ValueError(f"unknown solver {name!r}; registered: {sorted(SOLVERS)}") from None


def make_solver(name: str, **kwargs) -> FixedPoint:
    return get_solver(name)(**kwargs)


def _rhs(rhs, n: int, seed: int, rhs_scale: float):
    """The given right-hand side as fp32, or ``U[-rhs_scale, rhs_scale]``
    drawn from the counter-based source."""
    if rhs is None:
        u = uniform_table(seed, n)
        return u * (2.0 * rhs_scale) - rhs_scale
    return torch.from_numpy(np.array(rhs, np.float32))


def _shift(x, dim: int, up: bool):
    """``x`` moved one place along ``dim`` with a zero filling the gap:
    ``up`` gives ``[x[1:], 0]``, else ``[0, x[:-1]]``."""
    n = x.shape[dim]
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    if up:
        return torch.cat([x.narrow(dim, 1, n - 1), zero], dim=dim)
    return torch.cat([zero, x.narrow(dim, 0, n - 1)], dim=dim)


@register_solver("poisson1d")
def poisson_1d(n: int, *, omega: float = 1.0, shift: float = 0.0, rhs=None, seed: int = 0,
               rhs_scale: float = 10.0) -> FixedPoint:
    """The paper's S4 problem: A = tridiag(-1, 2+shift, -1), b in
    ``U[-rhs_scale, rhs_scale]``; ``f(x) = x + (omega/diag) * (b - Ax)``.
    ``shift > 0`` makes A strictly diagonally dominant (rho(|T|) <=
    2/(2+shift))."""
    diag = 2.0 + shift
    scale = omega / diag

    def f(data, x):
        ax = diag * x - _shift(x, -1, True) - _shift(x, -1, False)
        return x + scale * (data["rhs"] - ax)

    contraction = min(2.0 / (2.0 + shift), 1.0) if omega == 1.0 else None
    return FixedPoint(n=n, map_fn=f, data={"rhs": _rhs(rhs, n, seed, rhs_scale)},
                      name=f"poisson1d(n={n},omega={omega},shift={shift})",
                      contraction=contraction)


@register_solver("poisson2d")
def poisson_2d(nx: int, ny: Optional[int] = None, *, omega: float = 1.0, shift: float = 0.0,
               rhs=None, seed: int = 0, rhs_scale: float = 10.0) -> FixedPoint:
    """2-D Poisson: 5-point Laplacian on an ``nx x ny`` grid, weighted
    Jacobi; the flat iterate is the grid's row-major raveling, so a block
    is a band of grid rows.  rho(|T|) <= 4/(4+shift)."""
    ny = nx if ny is None else ny
    n = nx * ny
    diag = 4.0 + shift
    scale = omega / diag

    def f(data, x):
        g = x.reshape(x.shape[:-1] + (nx, ny))
        nbrs = (_shift(g, -2, True) + _shift(g, -2, False) + _shift(g, -1, True)
                + _shift(g, -1, False))
        ax = diag * g - nbrs
        return (g + scale * (data["rhs"].reshape(nx, ny) - ax)).reshape(x.shape)

    contraction = min(4.0 / (4.0 + shift), 1.0) if omega == 1.0 else None
    return FixedPoint(n=n, map_fn=f, data={"rhs": _rhs(rhs, n, seed, rhs_scale)},
                      name=f"poisson2d({nx}x{ny},omega={omega},shift={shift})",
                      contraction=contraction)


def _matvec(A, x):
    """``A @ x`` for every vector of ``x [..., n]``."""
    return x @ A.t()


@register_solver("jacobi_dense")
def jacobi_dense(A=None, b=None, *, omega: float = 1.0, n: int = 64, seed: int = 0,
                 dominance: float = 2.0) -> FixedPoint:
    """Weighted Jacobi on a dense system: ``f(x) = x + omega*D^-1(b - Ax)``.
    Without ``A``/``b``, a random strictly diagonally dominant system
    (rho(|T|) <= 1/dominance)."""
    contraction = None
    if A is None:
        A, b = random_dd_system(n, seed=seed, dominance=dominance)
        if omega == 1.0:
            contraction = 1.0 / dominance
    A = np.array(A, np.float32)
    dinv = np.float32(1.0) / np.diag(A)

    def f(data, x):
        return x + omega * data["dinv"] * (data["b"] - _matvec(data["A"], x))

    data = {"A": torch.from_numpy(A), "b": torch.from_numpy(np.array(b, np.float32)),
            "dinv": torch.from_numpy(dinv)}
    return FixedPoint(n=A.shape[0], map_fn=f, data=data, name=f"jacobi_dense(n={A.shape[0]})",
                      contraction=contraction)


@register_solver("richardson")
def richardson_dense(A=None, b=None, *, alpha: float = 0.1, n: int = 64,
                     seed: int = 0) -> FixedPoint:
    """Richardson iteration (a 'gradient method' in the paper's sense):
    ``f(x) = x + alpha*(b - Ax)``."""
    if A is None:
        A, b = random_dd_system(n, seed=seed)
        # normalize so alpha*A is a contraction on the default system
        A = A / np.abs(A).sum(axis=1, keepdims=True)
        b = b / np.abs(b).max()
    A = np.array(A, np.float32)

    def f(data, x):
        return x + alpha * (data["b"] - _matvec(data["A"], x))

    data = {"A": torch.from_numpy(A), "b": torch.from_numpy(np.array(b, np.float32))}
    return FixedPoint(n=A.shape[0], map_fn=f, data=data, name=f"richardson(n={A.shape[0]})")


@register_solver("d_iteration")
def d_iteration(n: int = 64, *, damping: float = 0.85, out_degree: int = 4, seed: int = 0,
                v=None) -> FixedPoint:
    """Sparse diffusion fixed point (the D-iteration family):
    ``f(x) = damping * P x + (1 - damping) * v`` with ``P``
    column-stochastic (``out_degree`` random successors a node plus a ring
    edge).  rho(|T|) = damping < 1."""
    rng = np.random.default_rng(seed)
    cols = np.zeros((n, n), np.float32)
    for j in range(n):
        succ = set(rng.choice(n, size=min(out_degree, n), replace=False).tolist())
        succ.add((j + 1) % n)  # ring edge: strong connectivity
        succ.discard(j)
        w = 1.0 / len(succ)
        for i in succ:
            cols[i, j] = w
    v = np.ones((n,), np.float32) / np.float32(n) if v is None else np.array(v, np.float32)

    def f(data, x):
        return damping * _matvec(data["P"], x) + (1.0 - damping) * data["v"]

    return FixedPoint(n=n, map_fn=f, data={"P": torch.from_numpy(cols), "v": torch.from_numpy(v)},
                      name=f"d_iteration(n={n},d={damping})", contraction=damping)


def random_dd_system(n: int, *, seed: int = 0, dominance: float = 2.0):
    """Random strictly diagonally dominant system (async-convergent Jacobi:
    rho(|T|) <= 1/dominance < 1).  Returns (A, b) as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1.0, 1.0, size=(n, n))
    np.fill_diagonal(A, 0.0)
    rowsum = np.abs(A).sum(axis=1)
    np.fill_diagonal(A, dominance * rowsum + 1e-3)
    b = rng.uniform(-10.0, 10.0, size=(n,))
    return A, b


def spectral_radius_abs_T(A: np.ndarray, iters: int = 200) -> float:
    """Power-iteration estimate of rho(|T|) for Jacobi T = I - D^-1 A."""
    D = np.diag(A)
    T = np.abs(np.eye(A.shape[0]) - A / D[:, None])
    v = np.ones(A.shape[0]) / np.sqrt(A.shape[0])
    lam = 0.0
    for _ in range(iters):
        w = T @ v
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 0.0
        v = w / lam
    return lam
