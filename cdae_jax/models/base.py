"""Model protocol + shared batching utilities.

Batched equivalent of the reference model hierarchy
(ref: src/model/model_base.hpp:17-66, src/model/recsys/recsys_model_base.hpp:18-109).
The protocol the solver/eval layers rely on:

  reset(data, seed)          -> state (params + optimizer accumulators)
  train_one_iteration(state, rng_key) -> state       (one epoch)
  current_loss(state)        -> float (data_loss + penalty_loss)
  batch_scores(state, uids, rated_items, rated_mask) -> (B, num_items) scores
  predict(state, users, items) -> per-pair predictions (RMSE/MAE evals)

Training operates on PaddedUserBatch views; ``iter_user_batches`` slices them
into fixed-size minibatches (last batch padded, weight 0) so every jit step
sees static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from cdae_jax.data.dataset import (
    Interactions,
    PaddedUserBatch,
    rows_from_csr,  # noqa: F401  (re-export; canonical home is data.dataset)
)


@dataclasses.dataclass
class UserMinibatch:
    """A fixed-size slice of a PaddedUserBatch (static shapes for jit)."""

    uids: np.ndarray  # (B,)
    items: np.ndarray  # (B, L) sorted asc, padded with num_items
    ratings: np.ndarray  # (B, L)
    mask: np.ndarray  # (B, L) bool
    lengths: np.ndarray  # (B,)
    weight: np.ndarray  # (B,) 1.0 for real rows, 0.0 for batch padding


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def ceil_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def iter_user_batches(
    pb: PaddedUserBatch,
    batch_size: int,
    order: Optional[np.ndarray] = None,
    bucket_by_length: bool = False,
) -> Iterator[UserMinibatch]:
    """Slice all users into fixed-size minibatches; pads the last batch.

    ``bucket_by_length`` sorts users by interaction count and trims each
    batch's item axis to the next power of two of its longest row — the
    padding-waste fix for skewed |rated| distributions (SURVEY §7 hard part
    (b)); the pow-2 bucketing bounds the number of distinct compiled shapes.
    """
    U = pb.num_users
    if order is None:
        order = (
            np.argsort(pb.lengths, kind="stable")
            if bucket_by_length
            else np.arange(U)
        )
    idx = order
    for start in range(0, U, batch_size):
        sel = idx[start : start + batch_size]
        pad = batch_size - len(sel)
        weight = np.ones(batch_size, dtype=np.float32)
        if pad > 0:
            sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
            weight[batch_size - pad :] = 0.0
        items = pb.items[sel]
        ratings = pb.ratings[sel]
        mask = pb.mask[sel]
        lengths = pb.lengths[sel] * weight.astype(np.int32)
        if bucket_by_length:
            L = min(ceil_pow2(max(int(lengths.max()), 1)), pb.max_len)
            items = items[:, :L]
            ratings = ratings[:, :L]
            mask = mask[:, :L]
        yield UserMinibatch(
            uids=pb.uids[sel],
            items=items,
            ratings=ratings,
            mask=mask & (weight[:, None] > 0),
            lengths=lengths,
            weight=weight,
        )


@dataclasses.dataclass
class ModelState:
    """Generic model state threaded through the solver loop: parameters +
    optimizer accumulators (the reference keeps both as members, e.g.
    imf.hpp:117-127; here they are explicit functional state)."""

    params: dict
    padded: Optional[PaddedUserBatch]
    num_users: int
    num_items: int
    step: int = 0
    aux: dict = dataclasses.field(default_factory=dict)


def iter_user_batches_csr(
    csr,
    num_items: int,
    batch_size: int,
    bucket_by_length: bool = True,
    max_len_cap: Optional[int] = None,
    slots_per_batch: Optional[int] = None,
) -> Iterator[UserMinibatch]:
    """Stream fixed-size user minibatches straight from a CSR view without
    materializing the full (U, max_len) padded matrix — the O(nnz) memory
    path for huge user counts (BASELINE.json configs 4-5: Netflix-scale /
    10M users). Semantics match iter_user_batches over Interactions.padded().

    ``slots_per_batch`` (token-budget batching): when set, the batch SIZE
    adapts per length bucket so B·L stays ~= the budget — B =
    clamp(pow2(slots/L), 8, batch_size), one program shape per bucket.
    Heavy-tailed degree distributions make this both a throughput and a
    MEMORY guard: at the config-5 shape a fixed bs4096 batch of the
    L=1024 bucket materializes (4096, 1024, D) gradient temporaries
    (~840 MB each), while bs4096 on the short buckets is what makes the
    light 80% of the epoch fast. Per-user math is batch-size-independent; only the
    minibatch AdaGrad cadence changes, exactly as with any batch-size
    choice.
    """
    lengths_all = csr.row_lengths().astype(np.int32)
    U = len(lengths_all)
    global_max = max(int(lengths_all.max()) if U else 1, 1)
    order = (
        np.argsort(lengths_all, kind="stable")
        if bucket_by_length
        else np.arange(U)
    )

    def emit(sel_1d, B):
        pad = B - len(sel_1d)
        weight = np.ones(B, dtype=np.float32)
        if pad > 0:
            sel_1d = np.concatenate([sel_1d, np.zeros(pad, sel_1d.dtype)])
            weight[B - pad:] = 0.0
        lengths = lengths_all[sel_1d] * weight.astype(np.int32)
        Lmax = max(int(lengths.max()), 1)
        # same bucket rule as the padded path: pow-2, capped at the global
        # max row length (keeps both paths shape- and RNG-identical)
        L = min(ceil_pow2(Lmax), global_max)
        if max_len_cap:
            L = min(L, max_len_cap)
        items = np.full((B, L), num_items, dtype=np.int32)
        ratings = np.zeros((B, L), dtype=np.float32)
        # vectorized ragged copy (live rows only; lengths already weighted)
        counts = np.minimum(lengths, L).astype(np.int64)
        total = int(counts.sum())
        if total:
            row_of = np.repeat(np.arange(B), counts)
            cum0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
            pos = np.arange(total) - np.repeat(cum0, counts)
            src = np.repeat(csr.indptr[sel_1d], counts) + pos
            items[row_of, pos] = csr.indices[src]
            ratings[row_of, pos] = csr.values[src]
        lengths = np.minimum(lengths, L)
        mask = np.arange(L)[None, :] < lengths[:, None]
        return UserMinibatch(
            uids=sel_1d.astype(np.int32),
            items=items,
            ratings=ratings,
            mask=mask,
            lengths=lengths,
            weight=weight,
        )

    if slots_per_batch:
        if not bucket_by_length:
            raise ValueError("slots_per_batch requires bucket_by_length")
        # one pow-2 length bucket at a time, batch size fit to the budget
        buckets = np.minimum(
            np.vectorize(ceil_pow2, otypes=[np.int64])(
                np.maximum(lengths_all[order], 1)
            ),
            min(global_max, max_len_cap or global_max),
        )
        start = 0
        while start < U:
            Lb = int(buckets[start])
            end = start + int(np.searchsorted(buckets[start:], Lb, "right"))
            B = slots_per_batch // max(Lb, 1)
            B = max(8, min(batch_size, 1 << max(int(B).bit_length() - 1, 3)))
            for s in range(start, end, B):
                yield emit(order[s:min(s + B, end)], B)
            start = end
        return

    for start in range(0, U, batch_size):
        yield emit(order[start:start + batch_size], batch_size)


def count_user_batches_csr(
    csr,
    batch_size: int,
    max_len_cap: Optional[int] = None,
    slots_per_batch: Optional[int] = None,
) -> int:
    """Number of batches iter_user_batches_csr will yield for the same
    arguments — computed from the row lengths alone (no batch arrays), so
    callers can stride/stratify a 10M-user epoch without materializing
    it."""
    lengths_all = csr.row_lengths().astype(np.int32)
    U = len(lengths_all)
    if not slots_per_batch:
        return -(-U // batch_size) if U else 0
    global_max = max(int(lengths_all.max()) if U else 1, 1)
    buckets = np.minimum(
        np.vectorize(ceil_pow2, otypes=[np.int64])(
            np.maximum(np.sort(lengths_all), 1)
        ),
        min(global_max, max_len_cap or global_max),
    )
    n = 0
    start = 0
    while start < U:
        Lb = int(buckets[start])
        end = start + int(np.searchsorted(buckets[start:], Lb, "right"))
        B = slots_per_batch // max(Lb, 1)
        B = max(8, min(batch_size, 1 << max(int(B).bit_length() - 1, 3)))
        n += -(-(end - start) // B)
        start = end
    return n


class RecsysModel:
    """Base class; concrete models implement the protocol methods."""

    name = "RecsysModel"

    def reset(self, data: Interactions, seed: int = 0):
        raise NotImplementedError

    def train_one_iteration(self, state, rng_key):
        raise NotImplementedError

    def current_loss(self, state, sample_size: int = 0) -> float:
        """data_loss + penalty_loss (ref model_base.hpp:28-33; the
        ``sample_size`` knob forwards to data_loss)."""
        return self.data_loss(state, sample_size) + self.penalty_loss(state)

    def data_loss(self, state, sample_size: int = 0) -> float:
        """Training-data loss estimate. ``sample_size`` > 0 restricts the
        estimate to the first sample_size instances, 0 = the full dataset
        (ref model_base.hpp:35-39; honored by LinearModel/FactorModel per
        linear_model.hpp:45-54 / factor_model.hpp:52-61, accepted and
        ignored elsewhere exactly like the reference, e.g. cdae.hpp:78)."""
        return 0.0

    def penalty_loss(self, state) -> float:
        return 0.0

    def batch_scores(self, state, uids, rated_items, rated_mask):
        """Full-catalog scores for a user minibatch; (B, num_items)."""
        raise NotImplementedError

    def predict(self, state, users, items):
        """Pointwise predictions for (user, item) pairs (RMSE/MAE evals)."""
        raise NotImplementedError

    def recommend(self, state, uids, train_data: Interactions, k: int = 10):
        """Top-k UNRATED item ids per user — the reference's recommend()
        (ref recsys_model_base.hpp:77-104: a per-user heap scan of the
        whole catalog; here one batched masked lax.top_k over the score
        matrix). ``train_data`` supplies the rated sets to exclude (and the
        encoder inputs for models that score from rated rows, e.g. CDAE).
        Returns (B, k) int32 ids; id == num_items marks a padding slot
        (catalog smaller than k)."""
        import jax.numpy as jnp

        from cdae_jax.ops.topk import topk_unrated

        uids = np.asarray(uids, dtype=np.int32).reshape(-1)
        pb = train_data.padded()
        rated, mask = pb.items[uids], pb.mask[uids]
        scores = self.batch_scores(state, uids, rated, mask)
        ids, _ = topk_unrated(jnp.asarray(scores), jnp.asarray(rated), k)
        return np.asarray(ids)
