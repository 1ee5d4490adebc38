"""Sharded (multi-chip) training and eval for the flagship CDAE model.

The genuinely new layer vs the reference (its training is one process of
std::threads, SURVEY §2e): the SAME jitted train step as single-chip CDAE
(models/cdae.py:_train_step), compiled under GSPMD with

  batch arrays      P('data', ...)   — users-axis data parallelism (exact:
                                       per-user grads are independent in the
                                       reference, cdae.hpp:136-146)
  W / V / b_prime   P('model', ...)  — item-axis tensor parallelism; XLA
                                       turns the encode gather + decoder
                                       matmul + scatter-grads into
                                       all-gather / reduce-scatter over ICI
  Wu / Uu           P('data', ...)   — user tables follow the batch axis
  b                 replicated       — psum'd gradient

Eval scoring shards the (B, num_items) score matrix over both axes and
merges per-shard top-k lists (parallel/topk.py).

Multi-host entry: call `jax.distributed.initialize()` before building the
mesh (ref equivalent: none — the reference cannot scale past one host).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cdae_jax.models.cdae import (
    CDAE,
    CDAEConfig,
    _batch_scores,
    _dense_train_step,
    _train_step,
)
from cdae_jax.parallel.mesh import (
    _fit_spec, batch_specs, cdae_param_specs, shard_params,
)


def make_sharded_train_step(model: CDAE, mesh: Mesh, params: Dict):
    """jit the full CDAE train step with explicit in/out shardings."""
    pspecs = cdae_param_specs(params)
    bspecs = batch_specs()
    param_sh = {
        k: NamedSharding(mesh, _fit_spec(mesh, s, params[k].shape))
        for k, s in pspecs.items()
    }
    step = functools.partial(_train_step, cfg=model.cfg, loss=model.loss)
    return jax.jit(
        step,
        in_shardings=(
            param_sh,
            NamedSharding(mesh, bspecs["uids"]),
            NamedSharding(mesh, bspecs["items"]),
            NamedSharding(mesh, bspecs["mask"]),
            NamedSharding(mesh, bspecs["lengths"]),
            NamedSharding(mesh, bspecs["weight"]),
            NamedSharding(mesh, P()),  # rng key replicated
        ),
        out_shardings=param_sh,
        donate_argnums=(0,),
    )


def make_sharded_dense_step(model: CDAE, mesh: Mesh, params: Dict):
    """jit the DENSE full-catalog train step under GSPMD: the (B, I)
    interaction/score slabs shard over ('data', 'model') — users-axis DP x
    item-axis TP — and every matmul becomes a sharded contraction with
    psum/reduce-scatter collectives inserted by XLA. The interaction matrix
    dense_R (U, I) lives sharded over both axes."""
    pspecs = cdae_param_specs(params)
    param_sh = {
        k: NamedSharding(mesh, _fit_spec(mesh, s, params[k].shape))
        for k, s in pspecs.items()
    }
    step = functools.partial(_dense_train_step, cfg=model.cfg,
                             loss=model.loss)
    return jax.jit(
        step,
        in_shardings=(
            param_sh,
            NamedSharding(mesh, P("data", "model")),  # dense_R
            NamedSharding(mesh, P("data")),  # uids
            NamedSharding(mesh, P("data")),  # weight
            NamedSharding(mesh, P()),  # rng key
        ),
        out_shardings=param_sh,
        donate_argnums=(0,),
    )


def make_sharded_mf_dense_step(model, mesh: Mesh, params: Dict):
    """jit a dense-mode MF step (IMF/PMF) under GSPMD: user tables shard
    over 'data', item tables over 'model', (B, I) slabs over both axes."""
    from cdae_jax.parallel.mesh import mf_param_specs

    pspecs = mf_param_specs(params)
    param_sh = {
        k: NamedSharding(mesh, _fit_spec(mesh, s, params[k].shape))
        for k, s in pspecs.items()
    }
    step = functools.partial(model._dense_step, cfg=model.cfg,
                             loss=model.loss)
    return jax.jit(
        step,
        in_shardings=(
            param_sh,
            NamedSharding(mesh, P("data", "model")),  # dense_R
            NamedSharding(mesh, P("data", "model")),  # ratings (or R again)
            NamedSharding(mesh, P("data")),  # uids
            NamedSharding(mesh, P("data")),  # weight
            NamedSharding(mesh, P()),  # rng key
        ),
        out_shardings=param_sh,
        donate_argnums=(0,),
    )


def make_sharded_fism_dense_step(model, mesh: Mesh, params: Dict):
    """jit the dense-slab FISM step (models/fism._fism_dense_step) under
    GSPMD: x/bu follow the users axis, P/Q/bi shard over 'model', the
    (B, I) pred/grad slabs over both — the x·Qᵀ decode and the gsᵀx / RᵀS
    gradient contractions become sharded matmuls with psums on the
    contracted axis."""
    from cdae_jax.models.fism import _fism_dense_step
    from cdae_jax.parallel.mesh import mf_param_specs

    pspecs = mf_param_specs(params)
    param_sh = {
        k: NamedSharding(mesh, _fit_spec(mesh, s, params[k].shape))
        for k, s in pspecs.items()
    }
    step = functools.partial(_fism_dense_step, cfg=model.cfg,
                             loss=model.loss)
    return jax.jit(
        step,
        in_shardings=(
            param_sh,
            None,  # dense_R keeps its committed (fitted) placement
            NamedSharding(mesh, P("data")),  # uids
            NamedSharding(mesh, P("data")),  # weight
            NamedSharding(mesh, P()),  # lr
            NamedSharding(mesh, P()),  # rng key
        ),
        out_shardings=param_sh,
        donate_argnums=(0,),
    )


def make_sharded_scores(model: CDAE, mesh: Mesh, params: Dict):
    """jit full-catalog scoring with (data, model)-sharded output."""
    pspecs = cdae_param_specs(params)
    param_sh = {
        k: NamedSharding(mesh, _fit_spec(mesh, s, params[k].shape))
        for k, s in pspecs.items()
    }
    fn = functools.partial(_batch_scores, cfg=model.cfg)
    return jax.jit(
        fn,
        in_shardings=(
            param_sh,
            NamedSharding(mesh, P("data")),
            NamedSharding(mesh, P("data", None)),
            NamedSharding(mesh, P("data", None)),
        ),
        out_shardings=NamedSharding(mesh, P("data", "model")),
    )


def shard_cdae_state(mesh: Mesh, params: Dict) -> Dict:
    """Place CDAE params onto the mesh with their canonical layout."""
    return shard_params(mesh, params, cdae_param_specs(params))


def make_batch(pb, sel: np.ndarray, batch_size: int):
    """Host-side fixed-size batch slicing — thin wrapper over the canonical
    iter_user_batches so the pad/weight invariants live in ONE place."""
    from cdae_jax.models.base import iter_user_batches

    b = next(iter_user_batches(pb, batch_size, order=np.asarray(sel)))
    return b.uids, b.items, b.mask, b.lengths, b.weight
