from cdae_jax.ops.losses import Loss, LossType
from cdae_jax.ops.penalties import Penalty, PenaltyType

__all__ = ["Loss", "LossType", "Penalty", "PenaltyType"]
