"""Model zoo registry (capability map: SURVEY.md §2b/§2c).

``create_model(name, **cfg)`` mirrors the reference app's ``--method``
dispatch (ref apps/yelp/yelp.cpp:110-199).
"""

from cdae_jax.models.base import ModelState, RecsysModel
from cdae_jax.models.cdae import CDAE, CDAEConfig
from cdae_jax.models.mf import BPR, IMF, MFConfig, PMF, WARP
from cdae_jax.models.als import ALS, ALSConfig, WRMF
from cdae_jax.models.fism import FISM, FISMConfig, FISMPair
from cdae_jax.models.linear import (
    FactorModel,
    FactorModelConfig,
    LinearModel,
    LinearModelConfig,
    NegMF,
)
from cdae_jax.models.popularity import Popularity
from cdae_jax.models.similarity import ItemCF, SimilarityConfig, UserCF

MODEL_REGISTRY = {
    "CDAE": (CDAE, CDAEConfig),
    "PMF": (PMF, MFConfig),
    "IMF": (IMF, MFConfig),
    "BPR": (BPR, MFConfig),
    "WARP": (WARP, MFConfig),
    "ALS": (ALS, ALSConfig),
    "WRMF": (WRMF, ALSConfig),
    "FISM": (FISM, FISMConfig),
    "FISMPAIR": (FISMPair, FISMConfig),
    "NEGMF": (NegMF, FactorModelConfig),
    "LINEAR": (LinearModel, LinearModelConfig),
    "FM": (FactorModel, FactorModelConfig),
    "POP": (Popularity, None),
    "ITEMCF": (ItemCF, SimilarityConfig),
    "USERCF": (UserCF, SimilarityConfig),
}


def create_model(name: str, **cfg):
    """Instantiate a model by registry name with config kwargs."""
    key = name.upper()
    if key not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        )
    cls, cfg_cls = MODEL_REGISTRY[key]
    if cfg_cls is None:
        return cls()
    return cls(**cfg) if cfg else cls()


__all__ = [
    "RecsysModel", "ModelState", "MODEL_REGISTRY", "create_model",
    "CDAE", "CDAEConfig", "PMF", "IMF", "BPR", "WARP", "MFConfig",
    "ALS", "WRMF", "ALSConfig", "FISM", "FISMPair", "FISMConfig",
    "NegMF", "LinearModel", "LinearModelConfig", "FactorModel",
    "FactorModelConfig", "Popularity", "ItemCF", "UserCF",
    "SimilarityConfig",
]
