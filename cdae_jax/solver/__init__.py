from cdae_jax.solver.solver import Solver, SGDSolver
from cdae_jax.solver import optimizer

__all__ = ["Solver", "SGDSolver", "optimizer"]
