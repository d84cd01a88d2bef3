"""The paper's own experiment config (S4): 1-D two-point BVP, n = 10000,
b ~ U[-10, 10], asynchronous relaxation, FDR-Infiniband-like 'concentrated'
environment (a copy of ``repro.configs.paper_poisson1d``)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperExperiment:
    n: int = 10000
    rhs_low: float = -10.0
    rhs_high: float = 10.0
    eps: float = 1e-5
    # 'concentrated' environment: tiny delays, near-full activity
    max_delay: int = 1
    activity: float = 0.95
    p_sweep: tuple = (2, 3, 4, 5, 6, 7, 8, 12, 16)
    # diagonally-dominant shift for protocol benchmarks (0.0 = paper's exact
    # operator; convergence then takes O(n^2) iterations — see bench notes)
    shift: float = 0.5


CONFIG = PaperExperiment()
