"""Neighborhood models: SimilarityBase, ItemCF, UserCF
(ref: src/model/recsys/similarity_base.hpp, itemcf.hpp, usercf.hpp).

Reference semantics: at reset, for every index entity (item for ItemCF, user
for UserCF) count co-occurrences with every other entity through the shared
data axis, normalize (Jaccard: c/(n_a+n_b-c); Cosine: c/sqrt(n_a·n_b),
similarity_base.hpp:79-87), and keep the top-k neighbors
(similarity_base.hpp:88-92, one thread-pool task per entity).

Batched form: co-occurrence counting is a blocked binary matmul
(C_blk = A_blk @ Aᵀ), normalization is fused elementwise, and neighbor
selection is `lax.top_k` per block — the whole neighbor build is a few
jitted kernels instead of a hash-map per entity. Scoring scatters neighbor
similarities into a (B, num_items) score matrix:

  ItemCF (itemcf.hpp:22-50): score[i] = Σ_{j ∈ rated(u)} sim(j→i)
  UserCF (usercf.hpp:21-54): score[i] = Σ_{v ∈ topk(u)} sim(u,v)·1[v rated i]
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cdae_jax.data.dataset import Interactions
from cdae_jax.models.base import ModelState, RecsysModel


@dataclasses.dataclass(frozen=True)
class SimilarityConfig:
    """SimilarityType + topk (ref similarity_base.hpp:34-40)."""

    sim_type: str = "JACCARD"  # JACCARD | COSINE
    topk: int = 50
    # --- build knobs ---
    block_size: int = 1024  # index rows per co-occurrence matmul block
    sharded: Optional[bool] = None  # mesh-parallel neighbor build
    # (build_topk_neighbors_sharded); None = auto when >1 device
    dtype: Any = jnp.float32


def _neighbor_block_math(
    A_blk: jnp.ndarray,  # (B, M) binary rows of the index entities
    A: jnp.ndarray,  # (N, M) all index entities
    counts_blk: jnp.ndarray,  # (B,)
    counts: jnp.ndarray,  # (N,)
    row_offset: jnp.ndarray,  # scalar — global id of A_blk[0] (self-mask)
    sim_type: str,
    topk: int,
):
    """One block of the neighbor build: count -> normalize -> top-k."""
    C = jnp.dot(A_blk, A.T, preferred_element_type=jnp.float32)  # (B, N)
    if sim_type == "JACCARD":
        denom = counts_blk[:, None] + counts[None, :] - C
        S = C / jnp.maximum(denom, 1e-12)
    else:  # COSINE
        S = C / jnp.maximum(
            jnp.sqrt(counts_blk[:, None] * counts[None, :]), 1e-12
        )
    B, N = C.shape
    self_ids = row_offset + jnp.arange(B)[:, None]
    is_self = jnp.arange(N)[None, :] == self_ids
    # only co-occurring candidates are eligible (ref builds the candidate
    # set from shared data entities, similarity_base.hpp:66-77)
    S = jnp.where((C > 0) & ~is_self, S, -jnp.inf)
    sims, ids = jax.lax.top_k(S, topk)
    valid = jnp.isfinite(sims)
    return (
        jnp.where(valid, ids, N).astype(jnp.int32),
        jnp.where(valid, sims, 0.0),
    )


_neighbor_block = functools.partial(
    jax.jit, static_argnames=("sim_type", "topk")
)(_neighbor_block_math)


@functools.partial(jax.jit, static_argnames=("M",))
def _binarize_rows(rows: jnp.ndarray, M: int) -> jnp.ndarray:
    """Padded index rows (N, L) int32 (pad >= M) -> dense (N, M) 0/1 f32,
    built ON DEVICE: the padded rows are ~20x smaller than the dense
    matrix at the ML-1M shape (about 4 MB against 89 MB to upload)."""
    N, L = rows.shape
    n_idx = jnp.arange(N, dtype=jnp.int32)[:, None]
    return jnp.zeros((N, M), jnp.float32).at[n_idx, rows].set(
        1.0, mode="drop"
    )


def build_topk_neighbors_rows(
    rows: np.ndarray,  # (N, L) int32 padded index rows (pad >= M)
    M: int,  # data-axis dimension
    sim_type: str,
    topk: int,
    block_size: int = 1024,
):
    """build_topk_neighbors from padded CSR rows — the H2D-light path
    (only O(nnz) index bytes cross to the device; binarization is a
    device scatter)."""
    A = _binarize_rows(jnp.asarray(rows), M)
    return _build_topk_neighbors_dev(A, sim_type, topk, block_size)


def build_topk_neighbors(
    binary: np.ndarray,  # (N, M) 0/1 — index entities × data entities
    sim_type: str,
    topk: int,
    block_size: int = 1024,
):
    """Full neighbor graph: (N, K) ids padded with N + (N, K) sims."""
    return _build_topk_neighbors_dev(
        jnp.asarray(binary, dtype=jnp.float32), sim_type, topk, block_size
    )


def _build_topk_neighbors_dev(A, sim_type, topk, block_size=1024):
    N = A.shape[0]
    counts = jnp.sum(A, axis=1)
    k = min(topk, max(N - 1, 1))
    # queue every block's device program, then ONE readback at the end
    # instead of a host sync per block
    outs = []
    for start in range(0, N, block_size):
        end = min(start + block_size, N)
        outs.append(_neighbor_block(
            A[start:end],
            A,
            counts[start:end],
            counts,
            jnp.int32(start),
            sim_type.upper(),
            k,
        ))
    ids_out = np.concatenate([np.asarray(i) for i, _ in outs])
    sims_out = np.concatenate([np.asarray(s) for _, s in outs])
    return ids_out, sims_out


def build_topk_neighbors_sharded(
    binary: np.ndarray,
    sim_type: str,
    topk: int,
    devices=None,
):
    """Mesh-parallel neighbor build: the block loop of
    ``build_topk_neighbors`` is embarrassingly parallel (each row block's
    count -> normalize -> top-k touches only its own output rows), so one
    shard_map over a flat device axis replaces the host loop — every device
    builds its row slice against the replicated binary matrix with ZERO
    collectives. Results are exactly equal to the serial build (same dots,
    per-row top-k independent of blocking)."""
    from cdae_jax.ops.shard_compat import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    devs = list(devices) if devices is not None else jax.devices()
    nd = len(devs)
    N = binary.shape[0]
    k = min(topk, max(N - 1, 1))
    rows_per = max(-(-N // nd), 1)
    Npad = rows_per * nd
    A = jnp.asarray(binary, jnp.float32)
    counts = jnp.sum(A, axis=1)
    Ap = jnp.pad(A, ((0, Npad - N), (0, 0)))
    cp = jnp.pad(counts, (0, Npad - N))
    offs = jnp.arange(nd, dtype=jnp.int32) * rows_per
    mesh = Mesh(np.array(devs), ("blk",))

    def local(blk, cnt_blk, off, A_full, counts_full):
        return _neighbor_block_math(
            blk, A_full, cnt_blk, counts_full, off[0],
            sim_type.upper(), k,
        )

    ids, sims = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("blk", None), P("blk"), P("blk"), P(), P()),
        out_specs=(P("blk", None), P("blk", None)),
        check_rep=False,
    ))(Ap, cp, offs, A, counts)
    return np.asarray(ids[:N]), np.asarray(sims[:N])


@jax.jit
def _itemcf_scores(nbr_ids, nbr_sims, rated_items, rated_mask, counts_shape_ref):
    """score[b, i] = Σ_{j ∈ rated(b)} sim(j→i) via scatter-add."""
    I = counts_shape_ref.shape[0]
    B, L = rated_items.shape
    ids = nbr_ids[jnp.clip(rated_items, 0, I - 1)]  # (B, L, K)
    sims = nbr_sims[jnp.clip(rated_items, 0, I - 1)]
    sims = sims * rated_mask[..., None]
    b_idx = jnp.arange(B)[:, None, None]
    return jnp.zeros((B, I)).at[
        jnp.broadcast_to(b_idx, ids.shape), ids
    ].add(sims, mode="drop")


@jax.jit
def _usercf_scores(nbr_ids, nbr_sims, uids, all_user_items, all_user_mask,
                   num_items):
    """score[b, i] = Σ_k sim(u_b, v_k)·1[v_k rated i] via scatter-add."""
    U = all_user_items.shape[0]
    B = uids.shape[0]
    nbrs = nbr_ids[uids]  # (B, K) padded with U
    sims = nbr_sims[uids]  # (B, K)
    nbrs_c = jnp.clip(nbrs, 0, U - 1)
    items = all_user_items[nbrs_c]  # (B, K, L)
    mask = all_user_mask[nbrs_c] & (nbrs[..., None] < U)
    vals = sims[..., None] * mask
    b_idx = jnp.arange(B)[:, None, None]
    I = num_items.shape[0]
    return jnp.zeros((B, I)).at[
        jnp.broadcast_to(b_idx, items.shape), items
    ].add(vals, mode="drop")


class SimilarityBase(RecsysModel):
    """Shared neighbor-build machinery; subclasses pick the axis."""

    index_axis = "item"  # entities that get neighbor lists

    def __init__(self, config: Optional[SimilarityConfig] = None, **kw):
        self.cfg = config if config is not None else SimilarityConfig(**kw)

    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        use_sharded = self.cfg.sharded
        if use_sharded is None:
            use_sharded = len(jax.devices()) > 1
        if use_sharded:
            binary = data.dense_matrix(binary=True)  # (U, I)
            mat = binary.T if self.index_axis == "item" else binary
            ids, sims = build_topk_neighbors_sharded(
                mat, self.cfg.sim_type, self.cfg.topk
            )
        else:
            # H2D-light path: ship only the padded CSR index rows and
            # binarize on device (see _binarize_rows)
            from cdae_jax.data.dataset import rows_from_csr

            if self.index_axis == "item":
                csr, N, M = data.csr_by_item(), data.num_items, data.num_users
            else:
                csr, N, M = data.csr(), data.num_users, data.num_items
            rows, _, _, _ = rows_from_csr(csr, np.arange(N), M)
            ids, sims = build_topk_neighbors_rows(
                rows, M, self.cfg.sim_type, self.cfg.topk,
                self.cfg.block_size,
            )
        state = ModelState(
            params={
                "nbr_ids": jnp.asarray(ids),
                "nbr_sims": jnp.asarray(sims),
            },
            padded=data.padded(),
            num_users=data.num_users,
            num_items=data.num_items,
        )
        return state

    def train_one_iteration(self, state, rng_key):
        return state  # ref similarity_base.hpp:117-119: no-op

    def data_loss(self, state, sample_size: int = 0) -> float:
        return 0.0  # ref similarity_base.hpp:101-104


class ItemCF(SimilarityBase):
    name = "ItemCF"
    index_axis = "item"

    def batch_scores(self, state, uids, rated_items, rated_mask):
        return _itemcf_scores(
            state.params["nbr_ids"],
            state.params["nbr_sims"],
            jnp.asarray(rated_items),
            jnp.asarray(rated_mask, dtype=jnp.float32),
            jnp.zeros((state.num_items,)),
        )

    def predict(self, state, users, items):
        users = np.asarray(users)
        pb = state.padded
        scores = self.batch_scores(
            state, users, pb.items[users], pb.mask[users]
        )
        return scores[jnp.arange(len(users)), jnp.asarray(items)]


class UserCF(SimilarityBase):
    name = "UserCF"
    index_axis = "user"

    def batch_scores(self, state, uids, rated_items, rated_mask):
        pb = state.padded
        return _usercf_scores(
            state.params["nbr_ids"],
            state.params["nbr_sims"],
            jnp.asarray(uids),
            jnp.asarray(pb.items),
            jnp.asarray(pb.mask),
            jnp.zeros((state.num_items,)),
        )

    def predict(self, state, users, items):
        users = np.asarray(users)
        pb = state.padded
        scores = self.batch_scores(
            state, users, pb.items[users], pb.mask[users]
        )
        return scores[jnp.arange(len(users)), jnp.asarray(items)]
