"""Global item-popularity baseline (ref: src/model/recsys/popularity.hpp).

The reference counts item occurrences at reset, sorts descending, and
recommends the most popular unrated items (popularity.hpp:43-61, :23-41).
Batched form: the count vector IS the score vector; recommendation is the
standard masked top-k over broadcast scores. Tie order may differ from the
reference's sort (both are arbitrary among equal counts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cdae_jax.data.dataset import Interactions
from cdae_jax.models.base import ModelState, RecsysModel


@functools.partial(jax.jit, static_argnames=("k", "cand"))
def _pop_topk(counts, rated_items, rated_mask, k: int, cand: int):
    """Top-k unrated by popularity — the reference's own algorithm shape
    (walk the count-sorted list skipping rated, popularity.hpp:23-41)
    instead of a (B, I) masked top-k: membership of only the top-``cand``
    candidates is tested against the rated rows (ops/sampling.is_rated
    chunked compare), then the first k survivors per row are selected by
    rank. Exact for every batch: rows that could exhaust the candidate
    list (rated more than cand-k of the top cand — ~10σ out at real
    degree distributions) trigger a lax.cond fallback to the full masked
    top-k."""
    from cdae_jax.ops.sampling import is_rated
    from cdae_jax.ops.topk import topk_unrated

    B = rated_items.shape[0]
    I = counts.shape[0]
    cand = min(cand, I)
    _, top_ids = jax.lax.top_k(counts, cand)  # popularity order, ties by id
    lengths = jnp.sum(rated_mask, axis=1).astype(jnp.int32)
    hits = is_rated(rated_items, lengths, top_ids.astype(jnp.int32))
    ok = ~hits  # (B, cand) unrated candidates, popularity-ordered
    rank = jnp.cumsum(ok, axis=1) - ok.astype(jnp.int32)
    exhausted = jnp.any(jnp.sum(ok, axis=1) < jnp.minimum(k, I))

    def fast(_):
        sel = jnp.where(ok & (rank < k), rank, k)  # target slot or drop
        b_idx = jnp.arange(B, dtype=jnp.int32)[:, None]
        out = jnp.full((B, k), I, jnp.int32)
        return out.at[b_idx, sel].set(
            jnp.broadcast_to(top_ids[None, :], (B, cand)), mode="drop"
        )

    def full(_):
        scores = jnp.broadcast_to(counts[None, :], (B, I))
        ids, _ = topk_unrated(scores, rated_items, k)
        return ids

    return jax.lax.cond(exhausted, full, fast, None)


class Popularity(RecsysModel):
    name = "Popularity"

    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        counts = np.bincount(data.items, minlength=data.num_items).astype(
            np.float32
        )
        return ModelState(
            params={"counts": jnp.asarray(counts)},
            padded=data.padded(),
            num_users=data.num_users,
            num_items=data.num_items,
        )

    def train_one_iteration(self, state, rng_key):
        return state  # ref popularity.hpp:19-21: training is a no-op

    def batch_scores(self, state, uids, rated_items, rated_mask):
        B = np.asarray(uids).shape[0]
        return jnp.broadcast_to(
            state.params["counts"][None, :], (B, state.num_items)
        )

    def batch_topk(self, state, uids, rated_items, rated_mask, k: int = 10):
        """Candidate-walk top-k (see _pop_topk) — the evaluator prefers
        this over materializing (B, I) broadcast scores."""
        return _pop_topk(
            state.params["counts"], jnp.asarray(rated_items),
            jnp.asarray(rated_mask), k, 128,
        )

    def predict(self, state, users, items):
        return state.params["counts"][jnp.asarray(items)]
