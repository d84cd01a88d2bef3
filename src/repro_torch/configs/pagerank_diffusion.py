"""PageRank-style example config for the ``d_iteration`` solver
(``repro_torch.asynchrony.SOLVERS['d_iteration']``; a copy of
``repro.configs.pagerank_diffusion``) — the D-iteration family's
damped-diffusion fixed point (arXiv:1301.3007, arXiv:1202.3108) run as an
asynchronous workload next to the paper's weighted-Jacobi experiment.

``f(x) = damping * P x + (1 - damping) * v`` with P column-stochastic;
rho(|T|) = damping, so any damping < 1 is asynchronously convergent and the
exact detector certifies the diffusion vector itself.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PageRankDiffusion:
    n: int = 256  # nodes (divisible by every p in p_sweep)
    damping: float = 0.85  # the classic PageRank damping
    out_degree: int = 4  # random successors per node (+ a ring edge)
    seed: int = 0
    eps: float = 1e-8  # mass scale is 1/n; certify well below it
    p_sweep: tuple = (2, 4, 8, 16)
    max_delay: int = 3
    activity: float = 0.7

    def solver_kwargs(self) -> dict:
        return dict(
            n=self.n, damping=self.damping,
            out_degree=self.out_degree, seed=self.seed,
        )


CONFIG = PageRankDiffusion()
