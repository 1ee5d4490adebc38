"""Distributed full-catalog top-k with rated-item exclusion (SURVEY §7
stage 6, hard part (e)).

Replaces the reference's per-user bounded-heap scan over the whole catalog
(ref src/model/recsys/recsys_model_base.hpp:77-104) for the sharded case:
score columns live item-sharded over the 'model' mesh axis, so each shard
computes a LOCAL top-k over its item slice, all-gathers the (n_shards · k)
candidates over ICI, and reduces to the global top-k — O(k·n_shards) bytes
on the wire instead of O(num_items).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cdae_jax.ops.topk import NEG_INF


def distributed_topk_unrated(
    mesh: Mesh,
    scores: jnp.ndarray,  # (B, I) sharded P('data', 'model')
    rated_items: jnp.ndarray,  # (B, L) int32 GLOBAL ids, padded with I
    k: int,
):
    """Top-k ids+vals per user over an item-sharded score matrix.

    Returns (ids, vals) with ids GLOBAL and both replicated over 'model'.
    """
    I = scores.shape[1]
    n_model = mesh.shape["model"]
    shard_width = I // n_model

    def _local(scores_blk, rated_blk):
        # scores_blk: (B_loc, I/n_model) — this shard's item slice
        midx = jax.lax.axis_index("model")
        offset = midx * shard_width
        # mask this shard's rated entries (global ids -> local columns)
        local = rated_blk - offset
        in_shard = (local >= 0) & (local < shard_width)
        col = jnp.where(in_shard, local, shard_width)  # OOB -> dropped
        b = jnp.arange(scores_blk.shape[0])[:, None]
        masked = scores_blk.at[b, col].set(NEG_INF, mode="drop")
        vals, ids = jax.lax.top_k(masked, k)  # (B_loc, k) local
        gids = ids + offset
        # gather every shard's candidates: (B_loc, n_model*k)
        all_vals = jax.lax.all_gather(vals, "model", axis=1, tiled=True)
        all_ids = jax.lax.all_gather(gids, "model", axis=1, tiled=True)
        fvals, fidx = jax.lax.top_k(all_vals, k)
        fids = jnp.take_along_axis(all_ids, fidx, axis=1)
        return fids.astype(jnp.int32), fvals

    fn = shard_map(
        _local,
        mesh=mesh,
        in_specs=(P("data", "model"), P("data", None)),
        out_specs=(P("data", None), P("data", None)),
        check_vma=False,
    )
    return fn(scores, rated_items)
