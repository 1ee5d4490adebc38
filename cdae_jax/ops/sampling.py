"""On-device negative sampling.

The reference rejection-samples uniform item ids until one is outside the
user's rated set (ref: src/model/recsys/recsys_model_base.hpp:46-70). That
data-dependent loop is hostile to XLA; we instead sample EXACTLY from the
complement of the rated set in closed form:

Given a user's rated items R sorted ascending (padded with num_items), the
u-th unrated item (u in [0, num_items - |R|)) is ``u + k`` where k is the
number of rated items r_j with ``r_j - j <= u``. Since ``R[j] - j`` is
non-decreasing, k is one searchsorted. This is an exact, rejection-free
equivalent of uniform sampling over unrated items.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_unrated(
    key: jax.Array,
    sorted_items: jnp.ndarray,  # (B, L) int32, ascending, padded with num_items
    lengths: jnp.ndarray,  # (B,) int32 — number of real (unpadded) entries
    num_items: int,
    num_samples: int,
) -> jnp.ndarray:
    """Uniform samples from each user's UNRATED items; (B, num_samples) int32.

    Rows where lengths == num_items have an empty complement: their samples
    come back as the SENTINEL id ``num_items`` (out of catalog). Callers
    must zero-weight slots with id >= num_items — clipping the sentinel to
    num_items-1 would turn a RATED item into a live negative.
    """
    B, L = sorted_items.shape
    free = jnp.maximum(num_items - lengths, 1)  # complement size per user
    u = jax.random.randint(
        key, (B, num_samples), minval=0, maxval=free[:, None],
        dtype=jnp.int32,
    )  # uniform over [0, free) per row; free >= 1
    # rank transform: R[j] - j is the count of unrated ids below R[j].
    # Padded slots must not perturb the (sorted) rank array: force them to
    # num_items, which exceeds every valid query u <= num_items - |R| - 1.
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    valid = pos < lengths[:, None]
    ranks = jnp.where(valid, sorted_items - pos, num_items)
    # k = number of rated ids skipped before reaching the u-th unrated id
    # = #{j : ranks[j] <= u}. ranks is already materialized, so for small
    # S count via a fused compare+reduce (B·L·S ops) instead of a vmapped
    # binary search. Chunk S to bound the (B, L, chunk) fusion working set.
    chunk = 32
    if num_samples <= chunk:
        k = jnp.sum(
            (ranks[:, :, None] <= u[:, None, :]).astype(jnp.int32), axis=1
        )
    elif num_samples <= 512:
        # mid-size S (e.g. WARP's nn·num_tries=320): chunked compare-sum
        S_pad = -(-num_samples // chunk) * chunk
        u_p = jnp.pad(u, ((0, 0), (0, S_pad - num_samples)))
        u_c = u_p.reshape(B, S_pad // chunk, chunk)

        def body(_, uc):
            return None, jnp.sum(
                (ranks[:, :, None] <= uc[:, None, :]).astype(jnp.int32),
                axis=1,
            )

        _, k_c = jax.lax.scan(body, None, jnp.moveaxis(u_c, 1, 0))
        k = jnp.moveaxis(k_c, 0, 1).reshape(B, S_pad)[:, :num_samples]
    else:
        # huge S (CDAE's num_neg·L): the B·L·S compare volume grows past
        # a vectorized search. method='sort' (concat + one sort) returns
        # the same ranks as the binary-search scan.
        k = jax.vmap(
            lambda r, q: jnp.searchsorted(r, q, side="right",
                                          method="sort"),
            in_axes=(0, 0),
        )(ranks, u)
    return (u + k).astype(jnp.int32)


def is_rated(
    sorted_items: jnp.ndarray,  # (B, L) int32, ascending, padded with num_items
    lengths: jnp.ndarray,  # (B,) int32 — number of real entries per row
    queries: jnp.ndarray,  # (Q,) shared or (B, Q) per-row int32 ids < num_items
) -> jnp.ndarray:
    """Membership of ``queries`` in each row's rated set; (B, Q) bool.

    The CSR-gathered replacement for ``dense_mask[uids][:, queries]`` when
    the (U, I) rated mask is never built (huge catalogs — see
    MFConfig.warp_pool). Fused compare+any, chunked over Q to bound the
    (B, L, chunk) working set.
    """
    B, L = sorted_items.shape
    if queries.ndim == 1:
        q = jnp.broadcast_to(queries[None, :], (B, queries.shape[0]))
    else:
        q = queries
    Q = q.shape[1]
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    # padding slots -> -1 so they can never match a valid (>= 0) query
    rows = jnp.where(pos < lengths[:, None], sorted_items, -1)
    chunk = 32
    if Q <= chunk:
        return jnp.any(rows[:, :, None] == q[:, None, :], axis=1)
    Q_pad = -(-Q // chunk) * chunk
    q_p = jnp.pad(q, ((0, 0), (0, Q_pad - Q)), constant_values=-1)
    q_c = jnp.moveaxis(q_p.reshape(B, Q_pad // chunk, chunk), 1, 0)

    def body(_, qc):
        return None, jnp.any(rows[:, :, None] == qc[:, None, :], axis=1)

    _, hit = jax.lax.scan(body, None, q_c)
    return jnp.moveaxis(hit, 0, 1).reshape(B, Q_pad)[:, :Q]
