"""Pluggable scalar losses, vectorized for the device.

Re-implements the reference loss registry (ref: src/model/loss.hpp:10-367)
as branch-free jnp functions usable inside jit/vmap. Each loss exposes
``evaluate(pred, truth)``, ``gradient(pred, truth)``, ``predict(x)`` and the
positive/negative label conventions the training loops rely on:

  loss            positive  negative   saturation guards (matching reference)
  SQUARE            1.        0.       —
  LOGISTIC          1.        0.       eval: log(max(1e-4, ·)); grad needs p∈(0,1)
  CROSS_ENTROPY     1.        0.       ±18 on the logit
  LOG               1.       -1.       ±18 on z = pred*truth
  LOGM              1.       -1.       ±18 on pred
  HINGE             1.       -1.       z > 1 → 0
  SQUARED_HINGE     1.       -1.       z > 1 → 0

All functions operate elementwise on arrays of any shape.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import jax.numpy as jnp


class LossType(enum.Enum):
    SQUARE = "SQUARE"
    LOGISTIC = "LOGISTIC"
    LOG = "LOG"
    HINGE = "HINGE"
    SQUARED_HINGE = "SQUARED_HINGE"
    CROSS_ENTROPY = "CROSS_ENTROPY"
    LOGM = "LOGM"

    @classmethod
    def parse(cls, name: str) -> "LossType":
        name = name.upper()
        aliases = {"CE": "CROSS_ENTROPY", "SQ_HINGE": "SQUARED_HINGE"}
        return cls(aliases.get(name, name))


@dataclasses.dataclass(frozen=True)
class Loss:
    """A loss bundle; create via ``Loss.create(LossType...)``."""

    kind: LossType
    evaluate: Callable  # (pred, truth) -> loss
    gradient: Callable  # (pred, truth) -> dloss/dpred
    predict: Callable  # raw score -> prediction
    positive_label: float
    negative_label: float

    @property
    def name(self) -> str:
        return self.kind.value

    @staticmethod
    def create(lt) -> "Loss":
        if isinstance(lt, str):
            lt = LossType.parse(lt)
        return _REGISTRY[lt]


# -- square: l = (y - a)^2 (ref loss.hpp:38-68) -------------------------------

def _square_eval(pred, truth):
    err = truth - pred
    return err * err


def _square_grad(pred, truth):
    return -2.0 * (truth - pred)


# -- logistic: l = -y log p - (1-y) log(1-p), p already in (0,1)
#    (ref loss.hpp:74-112; eval floors the log arg at 1e-4) -------------------

def _logistic_eval(pred, truth):
    p_pos = jnp.maximum(1e-4, pred)
    p_neg = jnp.maximum(1e-4, 1.0 - pred)
    return jnp.where(truth == 1.0, -jnp.log(p_pos), -jnp.log(p_neg))


def _logistic_grad(pred, truth):
    # reference CHECKs pred in (0,1); we clip for on-device safety
    p = jnp.clip(pred, 1e-7, 1.0 - 1e-7)
    return (p - truth) / (p * (1.0 - p))


# -- cross-entropy on logits: l = (1-y)a + log(1+exp(-a))
#    (ref loss.hpp:121-160 with ±18 saturation) -------------------------------

def _ce_eval(pred, truth):
    ret = (1.0 - truth) * pred
    mid = jnp.log1p(jnp.exp(-jnp.clip(pred, -18.0, 18.0)))
    tail = jnp.where(pred > 18.0, jnp.exp(-jnp.minimum(pred, 80.0)), -pred)
    return ret + jnp.where(jnp.abs(pred) <= 18.0, mid, tail)


def _ce_grad(pred, truth):
    low = jnp.exp(jnp.maximum(pred, -80.0)) - truth
    high = 1.0 - truth
    mid = 1.0 / (1.0 + jnp.exp(-jnp.clip(pred, -18.0, 18.0))) - truth
    return jnp.where(pred < -18.0, low, jnp.where(pred > 18.0, high, mid))


def _ce_predict(x):
    return 1.0 / (1.0 + jnp.exp(-x))


# -- log loss: l = log(1+exp(-a*y)) (ref loss.hpp:169-211) --------------------

def _log_eval(pred, truth):
    z = pred * truth
    mid = jnp.log1p(jnp.exp(-jnp.clip(z, -18.0, 18.0)))
    tail = jnp.where(z > 18.0, jnp.exp(-jnp.minimum(z, 80.0)), -z)
    return jnp.where(jnp.abs(z) <= 18.0, mid, tail)


def _log_grad(pred, truth):
    z = pred * truth
    high = -truth * jnp.exp(-jnp.minimum(z, 80.0))
    low = -truth
    mid = -truth / (1.0 + jnp.exp(jnp.clip(z, -18.0, 18.0)))
    return jnp.where(z > 18.0, high, jnp.where(z < -18.0, low, mid))


# -- multiplicative log loss: l = y log(1+exp(-a)) (ref loss.hpp:219-258) -----

def _logm_eval(pred, truth):
    z = pred
    mid = truth * jnp.log1p(jnp.exp(-jnp.clip(z, -18.0, 18.0)))
    tail = jnp.where(z > 18.0, truth * jnp.exp(-jnp.minimum(z, 80.0)), -z * truth)
    return jnp.where(jnp.abs(z) <= 18.0, mid, tail)


def _logm_grad(pred, truth):
    z = pred
    high = -truth * jnp.exp(-jnp.minimum(z, 80.0))
    low = -truth
    mid = -truth / (1.0 + jnp.exp(jnp.clip(z, -18.0, 18.0)))
    return jnp.where(z > 18.0, high, jnp.where(z < -18.0, low, mid))


# -- hinge: l = max(0, 1-a*y) (ref loss.hpp:267-302) --------------------------

def _hinge_eval(pred, truth):
    return jnp.maximum(0.0, 1.0 - pred * truth)


def _hinge_grad(pred, truth):
    return jnp.where(pred * truth > 1.0, 0.0, -truth)


# -- squared hinge: l = 0.5*max(0, 1-a*y)^2 (ref loss.hpp:310-346) ------------

def _sq_hinge_eval(pred, truth):
    d = jnp.maximum(0.0, 1.0 - pred * truth)
    return 0.5 * d * d


def _sq_hinge_grad(pred, truth):
    z = pred * truth
    return jnp.where(z > 1.0, 0.0, -truth * (1.0 - z))


def _identity(x):
    return x


_REGISTRY = {
    LossType.SQUARE: Loss(LossType.SQUARE, _square_eval, _square_grad, _identity, 1.0, 0.0),
    LossType.LOGISTIC: Loss(LossType.LOGISTIC, _logistic_eval, _logistic_grad, _identity, 1.0, 0.0),
    LossType.CROSS_ENTROPY: Loss(LossType.CROSS_ENTROPY, _ce_eval, _ce_grad, _ce_predict, 1.0, 0.0),
    LossType.LOG: Loss(LossType.LOG, _log_eval, _log_grad, _identity, 1.0, -1.0),
    LossType.LOGM: Loss(LossType.LOGM, _logm_eval, _logm_grad, _identity, 1.0, -1.0),
    LossType.HINGE: Loss(LossType.HINGE, _hinge_eval, _hinge_grad, _identity, 1.0, -1.0),
    LossType.SQUARED_HINGE: Loss(LossType.SQUARED_HINGE, _sq_hinge_eval, _sq_hinge_grad, _identity, 1.0, -1.0),
}
