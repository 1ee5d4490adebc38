"""cdae_jax — a JAX collaborative-filtering / recommender framework.

A brand-new JAX/XLA implementation of the full capability surface of
the reference C++ library libcf (jasonyaw/CDAE, WSDM'16): denoising-
autoencoder training over sparse user-item interactions (CDAE), a model zoo
of MF/ranking/neighborhood models, pluggable losses and penalties, AdaGrad
optimization, and batched on-device top-N evaluation — designed for
accelerators (batched SPMD training over device meshes instead of sequential per-user
SGD).

Layer map (mirrors reference /root/reference layering, see SURVEY.md §1):
  data/     — datasets, vocabularies, splits, caching (ref src/base/)
  ops/      — losses, penalties, corruption, sampling, top-k, metrics,
              row aggregation (ref src/model/loss.hpp, penalty.hpp,
              evaluation.hpp)
  models/   — CDAE + model zoo (ref src/model/, src/model/recsys/)
  solver/   — training loop, SGD solver, AdaGrad, line search
              (ref src/solver/)
  parallel/ — device meshes, sharded training/eval, distributed top-k,
              multi-host init (new; no ref equivalent)
  utils/    — config, logging, timers, profiling, checkpointing, host
              parallelism (ref src/base/)
  _native/  — C++ host runtime bindings (text loader, CSR builder)
"""

__version__ = "0.2.0"

from cdae_jax.data.dataset import Interactions
from cdae_jax.ops.losses import Loss, LossType
from cdae_jax.ops.penalties import Penalty, PenaltyType


def __getattr__(name):
    # lazy re-exports that would otherwise pull in jax-heavy modules
    if name in ("CDAE", "CDAEConfig", "create_model", "MODEL_REGISTRY"):
        import cdae_jax.models as _m

        return getattr(_m, name)
    if name in ("Solver", "SGDSolver"):
        import cdae_jax.solver.solver as _s

        return getattr(_s, name)
    if name in ("Evaluation", "EvalType"):
        import cdae_jax.evaluation as _e

        return getattr(_e, name)
    raise AttributeError(f"module 'cdae_jax' has no attribute {name!r}")


__all__ = [
    "Interactions",
    "Loss",
    "LossType",
    "Penalty",
    "PenaltyType",
    "CDAE",
    "CDAEConfig",
    "create_model",
    "MODEL_REGISTRY",
    "Solver",
    "SGDSolver",
    "Evaluation",
    "EvalType",
    "__version__",
]
