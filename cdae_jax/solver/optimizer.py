"""AdaGrad-style updates used across the model zoo.

The reference updates parameters per-touch with per-coordinate AdaGrad
accumulators initialized at 1e-4 and step ``lr * g / (beta + sqrt(acc))``
(e.g. ref src/model/recsys/cdae.hpp:230-236, imf.hpp:95-106). This build
accumulates gradients over a synchronous user minibatch (segment-sum) and
applies one AdaGrad step per batch — the standard accelerator reformulation
of Hogwild-style per-example updates.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

ADAGRAD_INIT = 1e-4  # ref: DMatrix::Constant(..., 0.0001) accumulators


def adagrad_update(
    param: jnp.ndarray,
    acc: jnp.ndarray,
    grad: jnp.ndarray,
    learn_rate: float,
    beta: float = 0.0,
    use_adagrad: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense AdaGrad step. Zero-gradient coordinates are untouched."""
    if use_adagrad:
        acc = acc + grad * grad
        param = param - learn_rate * grad / (beta + jnp.sqrt(acc))
    else:
        param = param - learn_rate * grad
    return param, acc


def adagrad_row_update(
    param: jnp.ndarray,  # (N, D) or (N,)
    acc: jnp.ndarray,
    rows: jnp.ndarray,  # (B,) int32 — must be unique within the batch
    grad_rows: jnp.ndarray,  # (B, D) or (B,)
    row_weight: jnp.ndarray,  # (B,) 0/1 — padded batch rows get 0
    learn_rate: float,
    beta: float = 0.0,
    use_adagrad: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sparse row-wise AdaGrad step via delta scatter-ADD: zero-weight
    (padding) rows contribute zero deltas, so duplicate row ids (padding
    reusing a live uid) cannot clobber a live update the way a duplicate
    .set could (scatter order is undefined)."""
    w = row_weight.astype(param.dtype)
    w = w.reshape((-1,) + (1,) * (grad_rows.ndim - 1))
    g = grad_rows * w
    if use_adagrad:
        gsq = g * g
        a_rows = acc[rows] + gsq
        acc = acc.at[rows].add(gsq, mode="drop")
        step = learn_rate * g / (beta + jnp.sqrt(a_rows))
    else:
        step = learn_rate * g
    param = param.at[rows].add(-step * (w > 0), mode="drop")
    return param, acc


def dense_adagrad_step(
    param: jnp.ndarray,
    acc: jnp.ndarray,
    grad: jnp.ndarray,
    learn_rate: float,
    beta: float = 0.0,
    use_adagrad: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Accumulate-then-apply AdaGrad with f32 optimizer arithmetic
    (accumulators stored f32; bf16 params round-trip through f32). The
    single shared implementation used by every model's dense updates."""
    g32 = grad.astype(jnp.float32)
    if use_adagrad:
        acc = acc + g32 * g32
        param = (
            param.astype(jnp.float32)
            - learn_rate * g32 / (beta + jnp.sqrt(acc))
        ).astype(param.dtype)
    else:
        param = (param.astype(jnp.float32) - learn_rate * g32).astype(
            param.dtype
        )
    return param, acc


def row_adagrad_delta(
    param: jnp.ndarray,  # (N, ...) table
    acc: jnp.ndarray,
    rows: jnp.ndarray,  # (B,) row ids; batch padding may DUPLICATE live ids
    grad_rows: jnp.ndarray,  # (B, ...) per-row grads (already weighted)
    live,  # (B, ...) bool broadcastable to grad_rows
    learn_rate: float,
    beta: float = 0.0,
    use_adagrad: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sparse per-row AdaGrad via delta scatter-ADD, f32 optimizer math.
    Delta-adds (never .set): zero-weight padding rows contribute zero
    deltas, so duplicate row ids cannot clobber a live update (scatter
    order is undefined for duplicate .set).

    Duplicate ids get SEQUENTIAL accumulator semantics within the call
    (an exact segmented prefix over g², computed via one stable sort):
    touch i of a row sees acc + sum of the EARLIER touches' g², exactly
    like the reference's per-touch loop (cdae.hpp:230-257). The earlier
    scheme gave every duplicate the PRE-call accumulator, so a hot item
    appearing in t users' rows took t near-full-size steps against the
    1e-4 init accumulator — measured −0.11 recall on the row_update
    parity cell (a latent round-4 bug caught by the round-5 full-matrix
    re-run; one-batch |dW| was 2.3x the dense path's)."""
    g32 = grad_rows.astype(jnp.float32)
    if use_adagrad:
        gsq = jnp.where(live, g32 * g32, 0.0)
        n = rows.shape[0]
        order = jnp.argsort(rows, stable=True)
        r_s = rows[order]
        q_s = gsq[order]
        csum = jnp.cumsum(q_s, axis=0)  # (N, ...) running g² in sort order
        idx = jnp.arange(n, dtype=jnp.int32)
        is_start = jnp.concatenate(
            [jnp.ones((1,), bool), r_s[1:] != r_s[:-1]]
        )
        start_idx = jax.lax.associative_scan(
            jnp.maximum, jnp.where(is_start, idx, 0)
        )
        csum_before_seg = jnp.where(
            (start_idx > 0)[(...,) + (None,) * (gsq.ndim - 1)],
            csum[jnp.maximum(start_idx - 1, 0)], 0.0,
        )
        # clamp: f32 cumsum cancellation can make the exclusive prefix
        # slightly NEGATIVE (error ~1e-5·csum), which overwhelms the 1e-4
        # accumulator init and NaNs the sqrt — observed as a full collapse
        # of the row_update+pool parity cell (K=4096 pool contributions
        # push csum into the hundreds)
        excl_prefix = jnp.maximum((csum - q_s) - csum_before_seg, 0.0)
        a_rows_s = acc[r_s] + excl_prefix + q_s
        step_s = learn_rate * g32[order] / (beta + jnp.sqrt(a_rows_s))
        live_s = (live[order] if getattr(live, "ndim", 0) else live)
        delta_s = jnp.where(live_s, -step_s, 0.0).astype(param.dtype)
        param = param.at[r_s].add(delta_s, mode="drop")
        acc = acc.at[rows].add(gsq, mode="drop")
        return param, acc
    step = learn_rate * g32
    delta = jnp.where(live, -step, 0.0).astype(param.dtype)
    param = param.at[rows].add(delta, mode="drop")
    return param, acc


def inverse_time_decay(lr0: float, reg: float, steps: jnp.ndarray) -> jnp.ndarray:
    """SGD learn-rate schedule lr0 / (1 + lr0*reg*steps)
    (ref src/solver/sgd-inl.hpp:84-91; off by default)."""
    return lr0 / (1.0 + lr0 * reg * steps)
