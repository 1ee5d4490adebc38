"""Batched masked top-k over the item catalog.

Replaces the reference's per-user bounded-heap scan over all items
(ref: src/model/recsys/recsys_model_base.hpp:77-104, heap.hpp:12-88) with a
single on-device ``jax.lax.top_k`` over score rows, after masking out each
user's already-rated items at -inf. ``streaming_topk_scores`` is the
blockwise form for catalogs whose (B, I) score matrix should not exist.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

# plain float, not a jnp array: module import must not initialize the XLA
# backend (jax.distributed.initialize has to run first on multi-host)
NEG_INF = float("-inf")


def mask_rated(
    scores: jnp.ndarray,  # (B, I) float
    rated_items: jnp.ndarray,  # (B, L) int32, padded with I (out of range)
) -> jnp.ndarray:
    """Set each user's rated item scores to -inf (padding ids are dropped)."""
    B, I = scores.shape
    # scatter -inf at rated positions; padded ids (== I) fall outside and are
    # dropped by scatter's OOB semantics
    return scores.at[
        jnp.arange(B, dtype=jnp.int32)[:, None], rated_items
    ].set(NEG_INF, mode="drop")


def topk_unrated(
    scores: jnp.ndarray,  # (B, I)
    rated_items: jnp.ndarray,  # (B, L) padded with I
    k: int,
):
    """Top-k item ids + scores excluding rated items. Returns (ids, vals).

    Catalogs smaller than k are padded with -inf slots whose ids come back
    as the sentinel ``I`` (never matches a real item in the metrics)."""
    I = scores.shape[1]
    masked = mask_rated(scores, rated_items)
    if I < k:
        masked = jnp.pad(
            masked, ((0, 0), (0, k - I)), constant_values=NEG_INF
        )
    vals, ids = jax.lax.top_k(masked, k)
    ids = jnp.where(ids >= I, I, ids)
    return ids.astype(jnp.int32), vals


@functools.partial(jax.jit, static_argnames=("k", "block"))
def streaming_topk_scores(
    z: jnp.ndarray,  # (B, D) hidden codes
    W: jnp.ndarray,  # (I, D) decoder table
    b_prime: jnp.ndarray,  # (I,)
    rated_items: jnp.ndarray,  # (B, L) padded with I
    k: int = 10,
    block: int = 16384,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k unrated items of ``z @ W.T + b_prime`` WITHOUT materializing
    the (B, I) scores. Returns (ids, vals).

    lax.scan over catalog blocks of ``block`` items: decode the block,
    mask the user's rated items falling in it, and merge into the running
    (B, k) top-k. Peak memory O(B·(block + k)). Ties resolve to the lower
    item id, as in ``topk_unrated``; slots with no unrated item left come
    back as the sentinel id ``I`` with value -inf.
    """
    B, D = z.shape
    I = W.shape[0]
    nblk = -(-I // block)
    Ip = nblk * block
    Wp = jnp.pad(W, ((0, Ip - I), (0, 0)))
    bpp = jnp.pad(b_prime, (0, Ip - I), constant_values=NEG_INF)

    def body(carry, blk_idx):
        run_vals, run_ids = carry
        start = blk_idx * block
        Wb = jax.lax.dynamic_slice(Wp, (start, 0), (block, D))
        bb = jax.lax.dynamic_slice(bpp, (start,), (block,))
        scores = z @ Wb.T + bb[None, :]  # (B, block)
        local = rated_items - start
        in_blk = (local >= 0) & (local < block)
        col = jnp.where(in_blk, local, block)  # out of range -> dropped
        b_idx = jnp.arange(B)[:, None]
        scores = scores.at[b_idx, col].set(NEG_INF, mode="drop")
        ids = start + jax.lax.broadcasted_iota(jnp.int32, (B, block), 1)
        # running entries first: on equal scores top_k keeps the earlier
        # column, i.e. the lower item id
        cat_vals = jnp.concatenate([run_vals, scores], axis=1)
        cat_ids = jnp.concatenate([run_ids, ids], axis=1)
        vals, idx = jax.lax.top_k(cat_vals, k)
        return (vals, jnp.take_along_axis(cat_ids, idx, axis=1)), None

    init = (
        jnp.full((B, k), NEG_INF, jnp.float32),
        jnp.full((B, k), I, jnp.int32),
    )
    (vals, ids), _ = jax.lax.scan(body, init, jnp.arange(nblk))
    return ids, vals
