"""Batched model evaluation (ref: src/model/evaluation.hpp:13-380).

Four evaluators mirroring the reference registry ``Evaluation<Model>::create``:

  RMSE / MAE — pointwise prediction error over validation pairs
               (ref evaluation.hpp:37-91)
  TOPN       — P@1/5/10, R@1/5/10, MAP@5/10 on a length-10 recommendation
               list per validation user, rated train items excluded
               (ref evaluation.hpp:95-219)
  RANKING    — NDCG@5/10 + Prec/Recall/MAP with relevance>=4 threshold
               (ref evaluation.hpp:223-361)

Batched architecture: instead of a thread pool calling ``model.recommend``
per user (ref evaluation.hpp:137-158), users are processed in fixed-size
batches; each batch is one jitted pipeline of
  full-catalog scores -> mask rated -> lax.top_k(10) -> per-user metric rows
and per-user rows are mean-reduced over the number of validation users
(ref evaluation.hpp:160-166). ``TestTime`` is reported as a metric column
like the reference (evaluation.hpp:109,177).
"""

from __future__ import annotations

import enum
import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cdae_jax.data.dataset import Interactions, rows_from_csr
from cdae_jax.ops import metrics as M
from cdae_jax.ops.topk import topk_unrated
from cdae_jax.utils.timer import Timer


class EvalType(enum.Enum):
    RMSE = "RMSE"
    MAE = "MAE"
    TOPN = "TOPN"
    RANKING = "RANKING"

    @classmethod
    def parse(cls, name) -> "EvalType":
        if isinstance(name, cls):
            return name
        return cls(str(name).upper())


@functools.partial(jax.jit, static_argnames=("columns",))
def _rec_metric_rows(
    scores, rated_items, val_items, val_ratings, val_mask, columns: str,
    rel_threshold=4.0,
):
    """scores (B,I) -> per-user metric rows (B,8) for TOPN or RANKING."""
    rec, _ = topk_unrated(scores, rated_items, 10)
    if columns == "TOPN":
        return M.topn_user_metrics(rec, val_items, val_mask)
    return M.ranking_user_metrics(rec, val_items, val_ratings, val_mask,
                                  rel_threshold)


@functools.partial(jax.jit, static_argnames=("columns",))
def _rec_metric_rows_from_ids(
    rec, val_items, val_ratings, val_mask, columns: str, rel_threshold=4.0
):
    """Pre-computed rec ids (B,10) -> per-user metric rows (B,8). Used when
    the model provides its own top-k (e.g. streaming/distributed top-k that
    never materializes the (B, num_items) score matrix)."""
    if columns == "TOPN":
        return M.topn_user_metrics(rec, val_items, val_mask)
    return M.ranking_user_metrics(rec, val_items, val_ratings, val_mask,
                                  rel_threshold)


@functools.partial(jax.jit, static_argnames=("kind",))
def _pointwise_partial(preds, labels, weight, kind: str):
    """Masked per-batch error sum (squared for RMSE, absolute for MAE) as a
    device scalar, so the eval loop can accumulate without host syncs."""
    err = (preds.astype(jnp.float32) - labels.astype(jnp.float32)) * weight
    if kind == "RMSE":
        return jnp.sum(err * err)
    return jnp.sum(jnp.abs(err))


class Evaluation:
    """Base evaluator; use ``Evaluation.create(kind)``."""

    kind: EvalType
    columns: tuple

    @staticmethod
    def create(kind, batch_size: int = 1024,
               rel_threshold: float = 4.0) -> "Evaluation":
        if isinstance(kind, Evaluation):  # pre-built (e.g. custom threshold)
            return kind
        kind = EvalType.parse(kind)
        if kind == EvalType.RMSE:
            return PointwiseEvaluation(EvalType.RMSE, batch_size)
        if kind == EvalType.MAE:
            return PointwiseEvaluation(EvalType.MAE, batch_size)
        if kind == EvalType.TOPN:
            return RecListEvaluation(EvalType.TOPN, batch_size)
        if kind == EvalType.RANKING:
            return RecListEvaluation(EvalType.RANKING, batch_size,
                                     rel_threshold)
        raise ValueError(f"unknown eval type {kind}")

    def evaluate(
        self,
        model,
        state,
        validation: Interactions,
        train: Optional[Interactions] = None,
    ) -> Dict[str, float]:
        raise NotImplementedError


class PointwiseEvaluation(Evaluation):
    """RMSE/MAE over validation (user, item, rating) triples
    (ref evaluation.hpp:37-91: sequential loop over instances calling
    model.predict; here: fixed-size batched predict)."""

    def __init__(self, kind: EvalType, batch_size: int = 4096):
        self.kind = kind
        self.columns = (kind.value,)
        self.batch_size = max(int(batch_size), 1)

    def evaluate(self, model, state, validation, train=None) -> Dict[str, float]:
        t = Timer()
        n = len(validation)
        if n == 0:
            return {self.kind.value: 0.0, "TestTime": t.elapsed()}
        # Per-batch partial sums stay ON DEVICE; one forced readback at the
        # end instead of a host sync per batch.
        total = jnp.zeros((), dtype=jnp.float32)
        bs = self.batch_size
        for start in range(0, n, bs):
            sel = slice(start, min(start + bs, n))
            users = validation.users[sel]
            items = validation.items[sel]
            labels = validation.ratings[sel]
            pad = bs - len(users)
            weight = np.ones(bs, dtype=np.float32)
            if pad > 0:  # keep shapes static for jit
                users = np.pad(users, (0, pad))
                items = np.pad(items, (0, pad))
                weight[bs - pad:] = 0.0
                labels = np.pad(labels, (0, pad))
            preds = model.predict(state, users, items)
            total = total + _pointwise_partial(
                preds, jnp.asarray(labels), jnp.asarray(weight),
                self.kind.value,
            )
        total = float(total)  # single host sync
        val = np.sqrt(total / n) if self.kind == EvalType.RMSE else total / n
        return {self.kind.value: float(val), "TestTime": t.elapsed()}


class RecListEvaluation(Evaluation):
    """TOPN / RANKING evaluation over length-10 rec lists."""

    def __init__(self, kind: EvalType, batch_size: int = 1024,
                 rel_threshold: float = 4.0):
        # larger batches amortize per-dispatch latency; memory is B x I
        # floats per score slab (drop batch_size for >100k-item catalogs)
        self.kind = kind
        self.rel_threshold = float(rel_threshold)
        self.columns = (
            M.TOPN_COLUMNS if kind == EvalType.TOPN else M.RANKING_COLUMNS
        )
        self.batch_size = max(int(batch_size), 1)
        self._cache_key = None
        self._cache = None

    def _batches(self, validation, train):
        """Device-resident eval batches, built once per (train, validation)
        pair — the solver evaluates the same datasets every cadence, so the
        padding + H2D transfer cost is paid a single time."""
        # key by identity AND hold strong refs: without the refs a GC'd
        # dataset's id() could be reused by a new object and serve stale
        # batches
        key = (train, validation, self.batch_size)
        if (
            self._cache_key is not None
            and self._cache_key[0] is train
            and self._cache_key[1] is validation
            and self._cache_key[2] == self.batch_size
        ):
            return self._cache
        # CSR-backed batches: only validation users' rows are padded —
        # O(selected nnz) memory rather than two full (U, max_len) matrices
        train_csr = train.csr()
        val_csr = validation.csr()
        val_users = np.nonzero(np.diff(val_csr.indptr) > 0)[0].astype(
            np.int32
        )
        # order by TRAIN row length: each batch's padded (B, L) rated rows
        # tighten to its own bucket's max, so the models' per-batch encode
        # gathers O(B·L_bucket) rows instead of O(B·L_global-max) — at
        # heavy-tailed degree distributions the padded gather is a large
        # share of serving time. Metric sums are order-invariant
        # (each user contributes one row; ref evaluation.hpp:160-166).
        tl = np.diff(train_csr.indptr)[val_users]
        val_users = val_users[np.argsort(tl, kind="stable")]
        batches = []
        # clamp to the validation population (next pow2): a 25-user fixture
        # must not pad every batch to 1024 rows
        pop = max(len(val_users), 1)
        bs = min(self.batch_size, 1 << (pop - 1).bit_length())
        for start in range(0, len(val_users), bs):
            sel = val_users[start : start + bs]
            pad = bs - len(sel)
            weight = np.ones(bs, dtype=np.float32)
            if pad > 0:
                weight[bs - pad :] = 0.0
                sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
            rated_items, _, rated_mask, _ = rows_from_csr(
                train_csr, sel, train.num_items
            )
            val_items, val_ratings, val_mask, _ = rows_from_csr(
                val_csr, sel, validation.num_items
            )
            val_mask = val_mask & (weight[:, None] > 0)
            batches.append((
                sel,
                jnp.asarray(rated_items),
                jnp.asarray(rated_mask),
                jnp.asarray(val_items),
                jnp.asarray(val_ratings),
                jnp.asarray(val_mask),
            ))
        self._cache_key = key
        self._cache = (len(val_users), batches)
        return self._cache

    def evaluate(self, model, state, validation, train=None) -> Dict[str, float]:
        t = Timer()
        if train is None:
            raise ValueError(f"{self.kind.value} evaluation requires train data")
        # only users with validation items are batched; others contribute
        # nothing to the sum (ref evaluation.hpp:139-144 skips them)
        num_val_users, batches = self._batches(validation, train)
        if num_val_users == 0:
            out = {c: 0.0 for c in self.columns}
            out["TestTime"] = t.elapsed()
            return out
        if hasattr(model, "pre_recommend"):
            model.pre_recommend(state)  # ref evaluation.hpp:135 hook
        # Column sums accumulate ON DEVICE across batches; ONE forced
        # readback per evaluate() call instead of a host sync per batch
        # (ref behavior preserved: evaluation.hpp:160-177 sums per-user
        # rows then divides once).
        col_sum_dev = jnp.zeros(len(self.columns), dtype=jnp.float32)
        has_topk = hasattr(model, "batch_topk")
        for (uids, rated_items, rated_mask, val_items, val_ratings,
             val_mask) in batches:
            rec = (
                model.batch_topk(state, uids, rated_items, rated_mask, 10)
                if has_topk else None
            )
            if rec is not None:
                rows = _rec_metric_rows_from_ids(
                    rec, val_items, val_ratings, val_mask, self.kind.value,
                    self.rel_threshold,
                )
            else:
                scores = model.batch_scores(
                    state, uids, rated_items, rated_mask
                )
                rows = _rec_metric_rows(
                    scores, rated_items, val_items, val_ratings, val_mask,
                    self.kind.value, self.rel_threshold,
                )
            col_sum_dev = col_sum_dev + jnp.sum(rows, axis=0)
        col_sum = np.asarray(col_sum_dev, dtype=np.float64)  # single sync
        out = {
            c: float(v / num_val_users) for c, v in zip(self.columns, col_sum)
        }
        out["TestTime"] = t.elapsed()
        return out
