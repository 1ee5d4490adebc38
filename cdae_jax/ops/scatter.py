"""Row aggregation strategies for data-dependent scatter-adds.

The pairwise model family (BPR/WARP/FISM, ref bpr.hpp:72-106,
warp.hpp:90-117) needs

    out[n] += sum_{p : idx[p] == n} vals[p]          (n < num_rows)

which is exactly a matmul against a one-hot matrix: ``onehot(idx).T @ vals``.
XLA fuses the ``iota == idx`` comparison into the dot-operand generation, so
the (P, N) one-hot need not reach device memory, and the sum runs as a
deterministic dense contraction instead of an atomic scatter.

Cost model: the matmul does 2·P·N·D FLOPs. For very large N·P that cost
outgrows a sort-based segment sum, so `scatter_add_rows` picks a strategy
by size (override via the `mode` argument).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp

# Optional trace-time hook: (mesh, axis) under which the factored
# aggregation's contraction over P runs inside an explicit shard_map —
# local partial dots + one psum over the batch axis. This is the
# compiler-PROOF way to distribute the (2·P·H·C·D)-FLOP aggregation einsum:
# GSPMD's solver, free to choose, prefers all-gathering the compact per-row
# values and REPLICATING the einsum (measured on the 8-dev mesh), and it may
# elide with_sharding_constraint nodes whose producers it replicated.
_BATCH_MESH = None


@contextlib.contextmanager
def batch_axis_mesh(mesh, axis: str = "data"):
    """Partition factored aggregations traced within this scope over
    ``axis``: rows split across the mesh, partial one-hot dots psum'd."""
    global _BATCH_MESH
    old = _BATCH_MESH
    _BATCH_MESH = (mesh, axis)
    try:
        yield
    finally:
        _BATCH_MESH = old

# One-hot matmul pays 2·P·N·D FLOPs; above this budget the sort/segment
# aggregation, whose cost does not grow with N, takes over.
_MATMUL_FLOP_LIMIT = 2.0e11


def matmul_scatter_add(idx: jnp.ndarray, vals: jnp.ndarray, num_rows: int,
                       *, precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """sum_p onehot(idx[p], num_rows) ⊗ vals[p] as one dense contraction.

    idx: (P,) int32 row ids (entries outside [0, num_rows) contribute 0 —
         callers use id == num_rows as a "dead slot" sentinel).
    vals: (P, D) or (P,) contributions.
    Returns (num_rows, D) or (num_rows,) sums, f32-exact per contribution
    (precision=HIGHEST keeps the dot in f32; the one-hot side is exact in
    any dtype).
    """
    squeeze = vals.ndim == 1
    if squeeze:
        vals = vals[:, None]
    oh = idx[:, None] == jax.lax.iota(idx.dtype, num_rows)[None, :]  # (P, N)
    out = jnp.einsum("pn,pd->nd", oh.astype(vals.dtype), vals,
                     precision=precision)
    return out[:, 0] if squeeze else out


def factored_matmul_scatter_add(
    idx: jnp.ndarray,
    vals: jnp.ndarray,
    num_rows: int,
    *,
    c: int = 0,
    vals_dtype=None,
) -> jnp.ndarray:
    """Two-level one-hot aggregation: ~N/C fewer FLOPs than the flat
    one-hot matmul when D is small (the pairwise models run D≈10, so a
    flat contraction's output tiles are mostly padding).

    Decompose id = hi·C + lo and pack (lo, d) jointly into the lane axis:

        RHS[p, lo·D+d] = [lo_p == lo] · v_p[d]          (P, C·D)
        out[hi·C+lo, d] = (OH_hiᵀ @ RHS)[hi, lo·D+d]    (H, C·D)

    One matmul of 2·P·H·(C·D) FLOPs — the lane axis now carries C·D ≈ 128+
    useful values instead of D — plus P·(H+C) one-hot compares instead of
    P·N. Both one-hot factors are exact in any dtype; vals ride in
    ``vals_dtype`` (default: input dtype, f32-exact).

    idx: (P,) int32; entries outside [0, num_rows) contribute nothing.
    """
    squeeze = vals.ndim == 1
    if squeeze:
        vals = vals[:, None]
    in_dtype = vals.dtype
    P, D = vals.shape
    if c <= 0:
        # target C·D ≈ 512 columns, power of two for cheap %//
        c = 512 // max(D, 1)
        c = max(8, min(128, 1 << max(c.bit_length() - 1, 3)))
    H = -(-num_rows // c)
    valid = (idx >= 0) & (idx < num_rows)
    idx_c = jnp.where(valid, idx, -1).astype(jnp.int32)
    hi = idx_c // c  # -1 stays -1 (floor division) -> matches no hi slot
    lo = idx_c % c
    vd = vals.dtype if vals_dtype is None else vals_dtype
    oh_hi = (hi[:, None] == jax.lax.iota(jnp.int32, H)[None, :]).astype(vd)
    oh_lo = (lo[:, None] == jax.lax.iota(jnp.int32, c)[None, :]).astype(vd)
    oh_lo = oh_lo * valid[:, None].astype(vd)  # -1 % c == c-1: mask it out
    # barrier: without it XLA fuses the vals PRODUCER into the (P, C·D)
    # broadcast and recomputes it per lo column (FISM's vals are themselves
    # gather+einsum chains)
    vals = jax.lax.optimization_barrier(vals.astype(vd))
    rhs = (oh_lo[:, :, None] * vals[:, None, :]).reshape(P, c * D)

    def agg_dot(a, b):
        return jnp.einsum("ph,pk->hk", a, b,
                          preferred_element_type=jnp.float32)

    if _BATCH_MESH is not None and P % (
        _BATCH_MESH[0].shape[_BATCH_MESH[1]]
    ) == 0:
        from cdae_jax.ops.shard_compat import shard_map
        from jax.sharding import PartitionSpec

        mesh, axis = _BATCH_MESH

        def local_dot(a, b):
            return jax.lax.psum(agg_dot(a, b), axis)

        out = shard_map(
            local_dot, mesh=mesh,
            in_specs=(PartitionSpec(axis, None), PartitionSpec(axis, None)),
            out_specs=PartitionSpec(None, None),
            check_rep=False,
        )(oh_hi, rhs)
    else:
        out = agg_dot(oh_hi, rhs)
    out = out.reshape(H * c, D)[:num_rows]
    out = out.astype(in_dtype)
    return out[:, 0] if squeeze else out


def sort_segment_add(idx: jnp.ndarray, vals: jnp.ndarray,
                     num_rows: int) -> jnp.ndarray:
    """Row-aggregation with NO P·N term: O(P log P + P·D + N·D).

    The one-hot matmul pays 2·P·N·D FLOPs, which grows with the catalog.
    This path is all parallel primitives:

      1. argsort idx
      2. gather vals into sorted order
      3. running cumsum over the sorted rows (log P passes)
      4. out[n] = cumsum[end_n] − cumsum[start_n]   (two searchsorted + gathers)

    Accuracy note: the cumsum-difference telescopes; each output row's error
    is bounded by the rounding of the global prefix at its boundaries
    (~eps·Σ|vals| relative to the prefix magnitude). For AdaGrad gradient
    magnitudes this matches the scatter path to ~1e-6 absolute (tested).

    idx: (P,) int32; entries >= num_rows (sentinels) fall off the end and
    contribute nothing. vals: (P,) or (P, D).
    """
    squeeze = vals.ndim == 1
    if squeeze:
        vals = vals[:, None]
    P = idx.shape[0]
    order = jnp.argsort(idx)
    sk = idx[order]
    sv = vals[order]
    csum = jnp.cumsum(sv, axis=0)
    # prefix[k] = sum of sv[:k]; out[n] = prefix[hi_n] - prefix[lo_n]
    prefix = jnp.concatenate([jnp.zeros((1, sv.shape[1]), sv.dtype), csum], 0)
    rows = jax.lax.iota(jnp.int32, num_rows)
    lo = jnp.searchsorted(sk, rows, side="left")
    hi = jnp.searchsorted(sk, rows, side="right")
    out = prefix[hi] - prefix[lo]
    return out[:, 0] if squeeze else out


def resolve_auto_mode(P: int, num_rows: int, d: int) -> str:
    """Strategy for mode='auto': the flat one-hot matmul while its FLOP
    cost is in budget, else the sort/segment aggregation whose cost is
    independent of the catalog size N (huge-catalog pairwise training: at
    N=1M, P=24k, D=11 the dot alone is ~0.5 TFLOP per step)."""
    flops = 2.0 * P * num_rows * d
    if flops > _MATMUL_FLOP_LIMIT:
        return "sort"
    return "matmul"


def scatter_add_rows(base: jnp.ndarray, idx: jnp.ndarray, vals: jnp.ndarray,
                     *, mode: str = "auto") -> jnp.ndarray:
    """base.at[idx].add(vals), strategy-selected
    (mode: auto|factored|factored_bf16|matmul|sort|scatter).

    "factored" is the two-level one-hot matmul (factored_matmul_scatter_add
    — ~N/C fewer FLOPs than flat one-hot when D is small; "factored_bf16"
    carries the values in bf16); "matmul" is the flat one-hot dot; "sort"
    argsort+cumsum segment aggregation (no P·N cost); "scatter" the native
    scatter-add. "auto" picks by FLOP budget (resolve_auto_mode): matmul
    while in budget, sort beyond it.
    """
    if mode == "scatter":
        return base.at[idx].add(vals)
    num_rows = base.shape[0]
    d = 1 if vals.ndim == 1 else vals.shape[-1]
    if mode == "auto":
        mode = resolve_auto_mode(idx.shape[0], num_rows, d)
    if mode == "sort":
        return base + sort_segment_add(idx, vals, num_rows)
    if mode == "factored":
        return base + factored_matmul_scatter_add(idx, vals, num_rows)
    if mode == "factored_bf16":
        return base + factored_matmul_scatter_add(
            idx, vals, num_rows, vals_dtype=jnp.bfloat16
        )
    if mode == "matmul":
        return base + matmul_scatter_add(idx, vals, num_rows)
    raise ValueError(f"unknown scatter mode {mode!r}")
