"""Alternating least squares: ALS and WRMF
(ref: src/model/recsys/als.hpp, wrmf.hpp — "Collaborative filtering for
implicit feedback datasets", ICDM'08 as shipped by libcf).

Reference semantics (als.hpp:65-98, wrmf.hpp:66-100): one iteration solves,
for every user u, the d×d normal equations over that user's OBSERVED items

  ALS:   (λI + Σ_{i∈R_u} y_i y_iᵀ)            x_u = Σ_{i∈R_u} r_ui y_i
  WRMF:  (λI + Σ_{i∈R_u} (s·r_ui) y_i y_iᵀ)   x_u = Σ_{i∈R_u} (s·r_ui) y_i

then symmetrically for every item (libcf regularizes with plain λI and sums
only over observed entries — replicated exactly). The reference inverts each
d×d system inside a dynamic thread pool (als.hpp:100-107); here each
side becomes ONE jitted batched solve: gather padded interaction rows,
build all A matrices with a masked einsum, and `jnp.linalg.solve` the
whole batch at once. Rows with no observations keep their old factors
(ref als.hpp:110-121 returns early).
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
from cdae_jax.ops.losses import Loss
from cdae_jax.ops.penalties import Penalty


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """Mirrors ALSConfig/WRMFConfig (ref als.hpp:10-16, wrmf.hpp:10-18)."""

    lambda_: float = 0.01
    scalar: float = 40.0  # WRMF confidence scale (ref wrmf.hpp:13)
    loss: str = "SQUARE"
    penalty: str = "L2"
    num_dim: int = 10
    # --- build knobs ---
    solve_batch: int = 4096  # rows per batched d×d solve
    w_solver: str = "ridge"  # WRMF solve: "ridge" = adaptive-jitter
    # Cholesky (jitter 16·eps·D·maxdiag(A) caps the 1/λ noise
    # amplification the f32 eigh truncation was built to kill; oracle
    # parity recorded by scripts/parity_zoo.py); "eigh" = the
    # noise-floor-truncated eigendecomposition, kept as the
    # reference-exact fallback
    dtype: Any = jnp.float32


def _solve_side_math(Y, idx, ratings, mask, lam, scalar, weighted,
                     w_solver="eigh"):
    """Batched normal-equation solve for one ALS sweep side (one chunk).

    Weighted (WRMF) solves use an eigendecomposition with a NOISE-FLOOR
    truncation instead of Cholesky: with confidence c = scalar·r (wrmf.hpp
    default 40) the Gram's data eigenvalues dwarf λ by ~1e8, and in f32 the
    rows with fewer than D observations have pure-rounding eigendirections
    whose rhs junk gets amplified by 1/λ each sweep — the factors overflow
    to NaN within one iteration (the f64 reference oracle survives on
    precision alone). Truncating directions whose DATA eigenvalue is below
    the row's f32 Gram noise floor reproduces the f64 oracle's metrics
    (parity_zoo ALS/WRMF cells) while keeping data-supported components
    exactly A⁻¹·rhs. Unweighted ALS (c = 1) stays on Cholesky — its
    conditioning is bounded and the SPD solve is cheaper than LU."""
    D = Y.shape[1]
    rows = Y[jnp.clip(idx, 0, Y.shape[0] - 1)]  # (B, L, D)
    m = mask.astype(Y.dtype)
    c = (scalar * ratings * m) if weighted else m  # per-entry A-weights
    A = jnp.einsum("bld,bl,ble->bde", rows, c, rows)
    A = A + lam * jnp.eye(D, dtype=Y.dtype)[None]
    rhs_w = (scalar * ratings * m) if weighted else (ratings * m)
    rhs = jnp.einsum("bld,bl->bd", rows, rhs_w)
    if not weighted:
        # A is SPD (Gram + λI): Cholesky instead of LU
        chol = jnp.linalg.cholesky(A)
        return jax.scipy.linalg.cho_solve((chol, True),
                                          rhs[..., None])[..., 0]
    if w_solver == "ridge":
        # adaptive-jitter Cholesky: μ = 16·eps·D·maxdiag(A) per row caps
        # the junk amplification at rhs_noise/μ (vs 1/λ) without the
        # batched eigh, which dominated the WRMF iteration.
        # Well-supported eigendirections have w >> μ and move O(μ/w).
        eps = jnp.finfo(Y.dtype).eps
        mu = 16.0 * eps * D * jnp.max(
            jnp.diagonal(A, axis1=-2, axis2=-1), axis=-1
        )
        Aj = A + mu[:, None, None] * jnp.eye(D, dtype=Y.dtype)[None]
        chol = jnp.linalg.cholesky(Aj)
        return jax.scipy.linalg.cho_solve((chol, True),
                                          rhs[..., None])[..., 0]
    w, V = jnp.linalg.eigh(A)  # ascending; w >= lam in exact arithmetic
    proj = jnp.einsum("bde,bd->be", V, rhs)
    noise = 16.0 * jnp.finfo(Y.dtype).eps * w[:, -1:]
    keep = (w - lam) > noise
    inv = jnp.where(keep, 1.0 / jnp.maximum(w, lam), 0.0)
    return jnp.einsum("bde,be->bd", V, proj * inv)


_solve_side = functools.partial(jax.jit, static_argnames=("weighted",))(
    _solve_side_math
)


def _sweep_scan(X, Y, idx_k, ratings_k, mask_k, lengths_k, N, lam, sc,
                weighted, w_solver="eigh"):
    """All chunks of one sweep side under lax.scan; rows with no
    observations keep their old factors (ref als.hpp:110-121)."""
    k, bs, _ = idx_k.shape
    D = X.shape[1]
    Xp = jnp.pad(X, ((0, k * bs - X.shape[0]), (0, 0)))

    def body(Xc, inp):
        j, idx, r, m, ln = inp
        solved = _solve_side_math(Y, idx, r, m, lam, sc, weighted,
                                  w_solver)
        start = j * bs
        old = jax.lax.dynamic_slice(Xc, (start, 0), (bs, D))
        keep = (ln > 0) & ((start + jnp.arange(bs)) < N)
        new = jnp.where(keep[:, None], solved, old)
        return jax.lax.dynamic_update_slice(Xc, new, (start, 0)), None

    Xp, _ = jax.lax.scan(
        body, Xp,
        (jnp.arange(k), idx_k, ratings_k, mask_k, lengths_k),
    )
    return Xp[: X.shape[0]]


@functools.partial(jax.jit, static_argnames=("weighted", "w_solver"),
                   donate_argnums=(0, 1))
def _als_iteration(p, q, user_side, item_side, lam, sc, weighted,
                   w_solver="eigh"):
    """One full ALS iteration — user sweep then item sweep against the
    UPDATED user factors (ref als.hpp:100-107) — as ONE device program."""
    p = _sweep_scan(p, q, *user_side, lam, sc, weighted, w_solver)
    q = _sweep_scan(q, p, *item_side, lam, sc, weighted, w_solver)
    return p, q


class ALS(RecsysModel):
    """Implicit-feedback ALS (ref als.hpp)."""

    name = "ALS"
    weighted = False

    def __init__(self, config: Optional[ALSConfig] = None, **kw):
        self.cfg = config if config is not None else ALSConfig(**kw)
        self.loss = Loss.create(self.cfg.loss)
        self.penalty = Penalty.create(self.cfg.penalty)

    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        U, I, D = data.num_users, data.num_items, self.cfg.num_dim
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        dt = self.cfg.dtype
        # DMatrix::Random()*0.001 → U(-0.001, 0.001) (ref als.hpp:47-48)
        params = {
            "p": jax.random.uniform(k1, (U, D), dt, -0.001, 0.001),
            "q": jax.random.uniform(k2, (I, D), dt, -0.001, 0.001),
        }
        state = ModelState(params=params, padded=data.padded(),
                           num_users=U, num_items=I)
        # item-side view: per-item padded user lists (ref als.hpp:52-53)
        by_item = Interactions(
            data.items, data.users, data.ratings, I, U
        ).padded()
        state.aux["by_item"] = by_item
        # device-resident padded sides, pre-padded to solve_batch multiples
        # (per-sweep host->device transfers dominated the iteration time)
        state.aux["dev_user_side"] = self._stage_side(state.padded)
        state.aux["dev_item_side"] = self._stage_side(by_item)
        return state

    def _stage_side(self, pb):
        """Side arrays pre-chunked (k, solve_batch, L) for the fused scan."""
        bs = self.cfg.solve_batch
        N = pb.num_users
        k = max(-(-N // bs), 1)
        pad = k * bs - N

        def padrows(a, fill=0):
            if pad > 0:
                shape = (pad,) + a.shape[1:]
                a = np.concatenate([a, np.full(shape, fill, a.dtype)])
            return jnp.asarray(a.reshape((k, bs) + a.shape[1:]))

        return (
            padrows(pb.items, pb.num_items),
            padrows(pb.ratings),
            padrows(pb.mask, False),
            padrows(pb.lengths),
            jnp.asarray(N, jnp.int32),
        )

    def train_one_iteration(self, state: ModelState, rng_key) -> ModelState:
        params = dict(state.params)
        # both sweeps in one device program (ref loop als.hpp:100-107)
        params["p"], params["q"] = _als_iteration(
            params["p"], params["q"],
            state.aux["dev_user_side"], state.aux["dev_item_side"],
            jnp.asarray(self.cfg.lambda_, self.cfg.dtype),
            jnp.asarray(self.cfg.scalar, self.cfg.dtype),
            self.weighted,
            w_solver=self.cfg.w_solver,
        )
        state.params = params
        state.step += 1
        return state

    def data_loss(self, state, sample_size: int = 0) -> float:
        return 0.0  # ref als.hpp uses base data_loss; wrmf.hpp:59-61 returns 0

    def penalty_loss(self, state) -> float:
        p = state.params
        return float(
            self.cfg.lambda_
            * (self.penalty.evaluate(p["p"]) + self.penalty.evaluate(p["q"]))
        )

    def batch_scores(self, state, uids, rated_items, rated_mask):
        return state.params["p"][jnp.asarray(uids)] @ state.params["q"].T

    def predict(self, state, users, items):
        return jnp.sum(
            state.params["p"][jnp.asarray(users)]
            * state.params["q"][jnp.asarray(items)],
            axis=-1,
        )


class WRMF(ALS):
    """Weighted-regularized MF: confidence s·r on observed entries
    (ref wrmf.hpp:66-100)."""

    name = "WRMF"
    weighted = True
