"""FISM — Factored Item Similarity Models (KDD'13) — pointwise + pairwise.

Reference: src/model/recsys/fism.hpp (pointwise, used by the SGD solver) and
fism_pair.hpp (pairwise; note the reference version has a broken include and
is not compiled — rebuilt here as a working capability, SURVEY §2c).

Model (fism.hpp:170-218):
  x_u    = Σ_{j∈R_u} p_j                      (cached per user)
  s(u,i) = b_u + b_i + scale · x̃_u · q_i
  scale  = 1/(|R_u|-1)^α for rated i (x̃_u = x_u − p_i),
           1/|R_u|^α     for unrated i (x̃_u = x_u)

Batched architecture: user-major minibatches like CDAE — one batch row
carries ALL of a user's positives (padded) plus num_neg·L sampled negatives,
so every per-instance gradient of the reference's inner loops
(fism.hpp:106-166) becomes one batched einsum + scatter-add, followed by a
single AdaGrad step (accumulators init 1e-4, no beta — fism.hpp:62-70,
:119-121). Batched-vs-sequential deviations (documented, metric-parity
judged): regularization λ·row is applied once per batch row rather than once
per touch, and the x_u cache is refreshed exactly (recomputed from updated P
for the batch's users) instead of incrementally tracked (fism.hpp:164).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cdae_jax.data.dataset import Interactions
from cdae_jax.models.base import ModelState, RecsysModel, iter_user_batches
from cdae_jax.ops import sampling
from cdae_jax.ops.losses import Loss
from cdae_jax.ops.penalties import Penalty
from cdae_jax.ops.scatter import scatter_add_rows
from cdae_jax.solver.optimizer import ADAGRAD_INIT, dense_adagrad_step


@dataclasses.dataclass(frozen=True)
class FISMConfig:
    """Mirrors FISMConfig (ref fism.hpp:8-20)."""

    lambda_: float = 0.01
    loss: str = "SQUARE"
    penalty: str = "L2"
    num_dim: int = 10
    num_neg: int = 5
    alpha: int = 1
    using_bias_term: bool = True
    using_factor_term: bool = True
    using_global_mean: bool = False
    using_adagrad: bool = True
    learn_rate: float = 0.01  # step_size comes from the SGD solver in the ref
    # --- build knobs ---
    batch_size: int = 128
    scatter_mode: str = "auto"  # row-aggregation strategy (ops/scatter.py)
    bucket_by_length: bool = True  # sort users by |R_u|, trim each batch's
    # item axis to the next pow-2 of its longest row: the sampling draws
    # num_neg·L per user, so padding to the GLOBAL max wasted ~6x at ML-1M
    # degree skew (ROADMAP r2); pow-2 bucketing bounds compile variants
    dense_mode: Optional[bool] = None  # full-catalog (B, I) slab step: every
    # gather/scatter becomes a matmul (see _fism_dense_step). None =
    # auto when the (U, I) rated mask + (B, I) slabs fit the HBM budget.
    dtype: Any = jnp.float32


def _scales(lengths, alpha, dtype):
    """(rated-scale, unrated-scale) per user (ref fism.hpp:128-134)."""
    n = lengths.astype(dtype)
    rated = 1.0 / jnp.maximum(n - 1.0, 1.0) ** alpha
    unrated = 1.0 / jnp.maximum(n, 1.0) ** alpha
    return rated, unrated


class FISM(RecsysModel):
    name = "FISM"
    pairwise = False

    def __init__(self, config: Optional[FISMConfig] = None, **kw):
        self.cfg = config if config is not None else FISMConfig(**kw)
        self.loss = Loss.create(self.cfg.loss)
        self.penalty = Penalty.create(self.cfg.penalty)
        self._lr = self.cfg.learn_rate
        step = _fism_pair_step if self.pairwise else _fism_step
        self._jit_step = jax.jit(
            functools.partial(step, cfg=self.cfg, loss=self.loss),
            donate_argnums=(0,),
        )
        self._jit_dense_step = None if self.pairwise else jax.jit(
            functools.partial(_fism_dense_step, cfg=self.cfg,
                              loss=self.loss),
            donate_argnums=(0,),
        )
        self._jit_scores = jax.jit(
            functools.partial(_fism_scores, alpha=self.cfg.alpha)
        )

    def set_learn_rate(self, lr: float) -> None:
        """SGDBase protocol: step size owned by the solver (ref sgd-inl.hpp)."""
        self._lr = float(lr)

    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        U, I, D = data.num_users, data.num_items, self.cfg.num_dim
        dt = self.cfg.dtype
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        # DMatrix::Random()*0.001 (ref fism.hpp:66-69); accumulators 1e-4
        params: Dict[str, jnp.ndarray] = {
            "bu": jnp.zeros((U,), dt),
            "bi": jnp.zeros((I,), dt),
            "bu_ag": jnp.full((U,), ADAGRAD_INIT, jnp.float32),
            "bi_ag": jnp.full((I,), ADAGRAD_INIT, jnp.float32),
            "P": jax.random.uniform(k1, (I, D), dt, -0.001, 0.001),
            "Q": jax.random.uniform(k2, (I, D), dt, -0.001, 0.001),
            "P_ag": jnp.full((I, D), ADAGRAD_INIT, jnp.float32),
            "Q_ag": jnp.full((I, D), ADAGRAD_INIT, jnp.float32),
        }
        pb = data.padded()
        # x cache: x_u = Σ_{j∈R_u} P_j (ref fism.hpp:71-78)
        rows = params["P"][jnp.clip(jnp.asarray(pb.items), 0, I - 1)]
        params["x"] = jnp.einsum(
            "uld,ul->ud", rows, jnp.asarray(pb.mask, dtype=dt)
        )
        state = ModelState(params=params, padded=pb, num_users=U, num_items=I)
        if self.cfg.using_global_mean and len(data):
            state.aux["global_mean"] = float(np.mean(data.ratings))
        dense = self.cfg.dense_mode
        if dense is None:
            dense = (
                not self.pairwise
                and U * I <= 1_500_000_000
                and self.cfg.batch_size * I * 40 <= 4_000_000_000
            )
        if dense and not self.pairwise:
            state.aux["dense_R"] = (
                jnp.zeros((U, I), jnp.int8)
                .at[jnp.asarray(data.users), jnp.asarray(data.items)]
                .set(1)
            )
        return state

    def _dense_user_batches(self, state: ModelState):
        if "dense_batches" not in state.aux:
            U = state.num_users
            B = min(self.cfg.batch_size, max(U, 1))
            k = max(-(-U // B), 1)
            uids = np.arange(k * B, dtype=np.int32) % U
            weight = (np.arange(k * B) < U).astype(np.float32)
            state.aux["dense_batches"] = (
                jnp.asarray(uids.reshape(k, B)),
                jnp.asarray(weight.reshape(k, B)),
            )
        return state.aux["dense_batches"]

    def train_one_iteration(self, state: ModelState, rng_key) -> ModelState:
        params = state.params
        if "dense_R" in state.aux and self._jit_dense_step is not None:
            R = state.aux["dense_R"]
            uid_mat, w_mat = self._dense_user_batches(state)
            lr = jnp.asarray(self._lr, self.cfg.dtype)
            for j in range(uid_mat.shape[0]):
                rng_key, sub = jax.random.split(rng_key)
                params = self._jit_dense_step(
                    params, R, uid_mat[j], w_mat[j], lr, sub
                )
            # per-batch x refresh is exact for the batch's users; P rows
            # shared with OTHER users moved too — one full rebuild per epoch
            params["x"] = (
                R.astype(self.cfg.dtype) @ params["P"]
            )
            state.params = params
            state.step += 1
            return state
        for batch in iter_user_batches(
                state.padded, self.cfg.batch_size,
                bucket_by_length=self.cfg.bucket_by_length):
            rng_key, sub = jax.random.split(rng_key)
            params = self._jit_step(
                params,
                jnp.asarray(batch.uids),
                jnp.asarray(batch.items),
                jnp.asarray(batch.mask),
                jnp.asarray(batch.lengths),
                jnp.asarray(batch.weight),
                jnp.asarray(self._lr, self.cfg.dtype),
                sub,
            )
        # end-of-epoch exact cache rebuild: later batches move P rows shared
        # with earlier users, so refresh x for ALL users before eval uses it
        params["x"] = _rebuild_x(
            params["P"],
            jnp.asarray(state.padded.items),
            jnp.asarray(state.padded.mask, dtype=self.cfg.dtype),
        )
        state.params = params
        state.step += 1
        return state

    def data_loss(self, state, sample_size: int = 0) -> float:
        return 0.0  # FISM trains via SGD solver; loss column unused in ref

    def penalty_loss(self, state) -> float:
        return 0.0

    def batch_scores(self, state, uids, rated_items, rated_mask):
        """Catalog scores with the UNRATED scale for every item — exactly the
        reference recommend() (fism.hpp:170-196: scale=1/|R_u|^α for all)."""
        return self._jit_scores(
            state.params, jnp.asarray(uids),
            jnp.asarray(state.padded.lengths)[jnp.asarray(uids)],
        )

    def predict(self, state, users, items):
        """Pointwise predict honoring the rated/unrated split
        (ref fism.hpp:198-215)."""
        p = state.params
        users = jnp.asarray(users)
        items = jnp.asarray(items)
        pb = state.padded
        u_np = np.asarray(users)
        rated_rows = jnp.asarray(pb.items[u_np])
        lengths = jnp.asarray(pb.lengths[u_np])
        I = state.num_items
        # membership test via searchsorted on the sorted padded rows
        pos = jax.vmap(jnp.searchsorted)(rated_rows, items)
        pos = jnp.clip(pos, 0, rated_rows.shape[1] - 1)
        is_rated = jnp.take_along_axis(
            rated_rows, pos[:, None], axis=1
        )[:, 0] == items
        s_rated, s_unrated = _scales(lengths, self.cfg.alpha, p["x"].dtype)
        x = p["x"][users]
        q = p["Q"][items]
        dot_unrated = jnp.sum(x * q, -1) * s_unrated
        dot_rated = jnp.sum((x - p["P"][items]) * q, -1) * s_rated
        return (
            p["bu"][users]
            + p["bi"][items]
            + jnp.where(is_rated, dot_rated, dot_unrated)
        )


def _fism_scores(params, uids, lengths, *, alpha):
    _, s_unrated = _scales(lengths, alpha, params["x"].dtype)
    return (
        params["bu"][uids][:, None]
        + params["bi"][None, :]
        + (params["x"][uids] @ params["Q"].T) * s_unrated[:, None]
    )


@jax.jit
def _rebuild_x(P, all_items, all_mask_f):
    rows = P[jnp.clip(all_items, 0, P.shape[0] - 1)]
    return jnp.einsum("uld,ul->ud", rows, all_mask_f)


def _refresh_x_rows(params, uids, items, mask_f, weight):
    """Exact x-cache refresh for the batch's users from updated P.
    Delta-add (not .set): padding rows duplicate real uids with weight 0
    and a duplicate .set could clobber the live row (undefined order)."""
    I = params["P"].shape[0]
    rows = params["P"][jnp.clip(items, 0, I - 1)]
    x_new = jnp.einsum("bld,bl->bd", rows, mask_f)
    live = weight[:, None] > 0
    delta = jnp.where(live, x_new - params["x"][uids], 0.0)
    return params["x"].at[uids].add(delta, mode="drop")


def _fism_adagrad(params, grads, lr, cfg):
    """AdaGrad without beta (ref fism.hpp:119-121: grad /= sqrt(acc)) —
    the shared helper with beta=0."""
    out = dict(params)
    for name, g in grads.items():
        out[name], out[name + "_ag"] = dense_adagrad_step(
            params[name], params[name + "_ag"], g, lr, 0.0,
            cfg.using_adagrad,
        )
    return out


def _fism_step(params, uids, items, mask, lengths, weight, lr, key, *, cfg,
               loss):
    """Batched pointwise FISM epoch step (ref fism.hpp:92-166)."""
    I, D = params["P"].shape
    B, L = items.shape
    lam = cfg.lambda_
    dt = params["P"].dtype
    w = weight.astype(dt)
    mask_f = mask.astype(dt) * w[:, None]
    items_c = jnp.clip(items, 0, I - 1)

    s_rated, s_unrated = _scales(lengths, cfg.alpha, dt)
    x = params["x"][uids]  # (B, D)
    P_rows = params["P"][items_c]  # (B, L, D)
    Q_pos = params["Q"][items_c]  # (B, L, D)

    # positives: pred_i = bu + bi + s_r·(x − p_i)·q_i
    pred_pos = (
        params["bu"][uids][:, None]
        + params["bi"][items_c]
        + jnp.einsum("bld,bld->bl", x[:, None, :] - P_rows, Q_pos)
        * s_rated[:, None]
    )
    g_pos = loss.gradient(pred_pos, loss.positive_label) * mask_f  # (B, L)

    # negatives: num_neg per positive (ref fism.hpp:92-104)
    nn = max(cfg.num_neg, 0)
    Nn = max(nn * L, 1)
    neg = sampling.sample_unrated(key, items, lengths, I, Nn)
    neg_c = jnp.clip(neg, 0, I - 1)
    # sentinel id I = empty complement -> zero-weight those slots
    neg_mask = (
        jnp.tile(mask_f, (1, nn)) * (neg < I).astype(dt)
        if nn > 0 else jnp.zeros((B, Nn), dt)
    )
    Q_neg = params["Q"][neg_c]  # (B, Nn, D)
    pred_neg = (
        params["bu"][uids][:, None]
        + params["bi"][neg_c]
        + jnp.einsum("bd,bnd->bn", x, Q_neg) * s_unrated[:, None]
    )
    g_neg = loss.gradient(pred_neg, loss.negative_label) * neg_mask

    grads = {}
    sm = cfg.scatter_mode
    D_ = params["P"].shape[1]
    # one flat index vector over positives + negatives; Q and bi grads ride
    # ONE strategy-selected row aggregation (ops/scatter.py) instead of the
    # serialized per-row scatters — bi as an extra value column
    all_idx = jnp.concatenate([items.reshape(-1), neg.reshape(-1)])
    if cfg.using_bias_term:
        grads["bu"] = jnp.zeros_like(params["bu"]).at[uids].add(
            jnp.sum(g_pos, 1) + jnp.sum(g_neg, 1)
            + lam * params["bu"][uids] * w
        )

    if cfg.using_factor_term:
        # Q gradients (ref fism.hpp:145-160)
        gq_pos = (
            (g_pos * s_rated[:, None])[..., None] * (x[:, None, :] - P_rows)
            + lam * Q_pos
        ) * mask_f[..., None]
        gq_neg = (
            (g_neg * s_unrated[:, None])[..., None] * x[:, None, :]
            + lam * Q_neg
        ) * neg_mask[..., None]
        q_vals = jnp.concatenate(
            [gq_pos.reshape(-1, D_), gq_neg.reshape(-1, D_)]
        )
        if cfg.using_bias_term:
            bi_vals = jnp.concatenate([
                (g_pos + lam * params["bi"][items_c] * mask_f).reshape(-1),
                (g_neg + lam * params["bi"][neg_c] * neg_mask).reshape(-1),
            ])
            agg = scatter_add_rows(
                jnp.zeros((params["Q"].shape[0], D_ + 1), q_vals.dtype),
                all_idx,
                jnp.concatenate([q_vals, bi_vals[:, None]], axis=1),
                mode=sm,
            )
            grads["Q"] = agg[:, :D_]
            grads["bi"] = agg[:, D_]
        else:
            grads["Q"] = scatter_add_rows(
                jnp.zeros_like(params["Q"]), all_idx, q_vals, mode=sm
            )
        # P gradients: every rated j gets Σ_instances g·q·scale, minus the
        # self term for positive j (ref fism.hpp:136-144 skips jid==iid)
        S = (
            jnp.einsum("bl,bld->bd", g_pos, Q_pos) * s_rated[:, None]
            + jnp.einsum("bn,bnd->bd", g_neg, Q_neg) * s_unrated[:, None]
        )  # (B, D)
        gp = (
            S[:, None, :]
            - (g_pos * s_rated[:, None])[..., None] * Q_pos
            + lam * P_rows
        ) * mask_f[..., None]
        grads["P"] = scatter_add_rows(
            jnp.zeros_like(params["P"]), items.reshape(-1),
            gp.reshape(-1, D_), mode=sm,
        )
    elif cfg.using_bias_term:
        grads["bi"] = scatter_add_rows(
            jnp.zeros_like(params["bi"]), all_idx,
            jnp.concatenate([
                (g_pos + lam * params["bi"][items_c] * mask_f).reshape(-1),
                (g_neg + lam * params["bi"][neg_c] * neg_mask).reshape(-1),
            ]),
            mode=sm,
        )

    params = _fism_adagrad(params, grads, lr, cfg)
    if cfg.using_factor_term:
        params["x"] = _refresh_x_rows(params, uids, items, mask_f, w)
    return params


def _fism_dense_step(params, R, uids, weight, lr, key, *, cfg, loss):
    """Full-catalog dense-slab pointwise FISM step (ref fism.hpp:92-166
    reformulated as matmuls): with R the (B, I) rated mask and x the
    per-user cache x_u = Σ_{k∈R_u} p_k, every gather/scatter of the sparse
    step becomes a matmul —

      pred = bu + bi + (x Qᵀ − R ⊙ Σ_d P⊙Q) · scale       (x̃·q in slab form)
      dQ   = g̃ᵀ x − diag(Σ_b g̃⊙R) P     (g̃ = loss-grad · touch · scale)
      dP   = Rᵀ (g̃ Q) − diag(Σ_b g̃⊙R) Q  (self-term k=i excluded exactly)

    Negatives are Bernoulli over the complement with E[count] = num_neg·|R_u|
    per user — the same expected-touch-preserving substitution the dense IMF
    path uses (metric parity recorded in BASELINE.md). Per-touch λ terms
    follow the sparse step's conventions exactly."""
    dt = params["P"].dtype
    w_user = weight.astype(dt)  # (B,)
    rows = R[uids].astype(dt) * w_user[:, None]  # (B, I)
    I = rows.shape[1]
    lengths = jnp.sum(rows, axis=1)
    s_rated, s_unrated = _scales(lengths, cfg.alpha, dt)
    p_neg = jnp.clip(
        cfg.num_neg * lengths / jnp.maximum(I - lengths, 1.0), 0.0, 1.0
    )
    u01 = jax.random.uniform(key, rows.shape)
    neg_sel = (
        (1.0 - rows) * (u01 < p_neg[:, None]).astype(dt) * w_user[:, None]
    )
    touch = rows + neg_sel  # (B, I) instances this step
    x = params["x"][uids]  # (B, D) cache (exact at batch entry)
    base = x @ params["Q"].T  # (B, I)
    corr = jnp.sum(params["P"] * params["Q"], axis=1)  # (I,) p_i·q_i
    scale = jnp.where(rows > 0, s_rated[:, None], s_unrated[:, None])
    pred = (
        params["bu"][uids][:, None]
        + params["bi"][None, :]
        + (base - rows * corr[None, :]) * scale
    )
    labels = jnp.where(rows > 0, loss.positive_label, loss.negative_label)
    g = loss.gradient(pred, labels) * touch  # (B, I)
    gs = g * scale  # g̃
    lam = cfg.lambda_
    grads = {}
    if cfg.using_bias_term:
        grads["bu"] = jnp.zeros_like(params["bu"]).at[uids].add(
            jnp.sum(g, axis=1) + lam * params["bu"][uids] * w_user
        )
        grads["bi"] = (
            jnp.sum(g, axis=0) + lam * params["bi"] * jnp.sum(touch, axis=0)
        )
    if cfg.using_factor_term:
        touch_i = jnp.sum(touch, axis=0)  # (I,)
        rated_g = jnp.sum(gs * rows, axis=0)  # (I,) self-term weights
        grads["Q"] = (
            gs.T @ x
            - rated_g[:, None] * params["P"]
            + lam * params["Q"] * touch_i[:, None]
        )
        S_rows = gs @ params["Q"]  # (B, D) Σ_i g̃·q_i per user
        grads["P"] = (
            rows.T @ S_rows
            - rated_g[:, None] * params["Q"]
            + lam * params["P"] * jnp.sum(rows, axis=0)[:, None]
        )
    params = _fism_adagrad(params, grads, lr, cfg)
    if cfg.using_factor_term:
        # exact x refresh for the batch's users from the UPDATED P
        x_new = rows @ params["P"]
        delta = jnp.where(w_user[:, None] > 0, x_new - params["x"][uids], 0.0)
        params["x"] = params["x"].at[uids].add(delta, mode="drop")
    return params


def _fism_pair_step(params, uids, items, mask, lengths, weight, lr, key, *,
                    cfg, loss):
    """Batched pairwise FISM (rebuilt from fism_pair.hpp:100-161): for each
    positive i and sampled negative j, gradient on s(u,i)−s(u,j) with
    truth 1; x̃_u = x_u − p_i for BOTH sides (as in the reference)."""
    I, D = params["P"].shape
    B, L = items.shape
    lam = cfg.lambda_
    dt = params["P"].dtype
    w = weight.astype(dt)
    mask_f = mask.astype(dt) * w[:, None]
    items_c = jnp.clip(items, 0, I - 1)

    s_rated, _ = _scales(lengths, cfg.alpha, dt)
    x = params["x"][uids]
    P_rows = params["P"][items_c]
    Q_pos = params["Q"][items_c]

    nn = max(cfg.num_neg, 1)
    Nn = nn * L
    neg = sampling.sample_unrated(key, items, lengths, I, Nn)
    neg_valid = (neg.reshape(B, nn, L) < I).astype(dt)
    neg_c = jnp.clip(neg.reshape(B, nn, L), 0, I - 1)  # (B, nn, L)
    Q_neg = params["Q"][neg_c]  # (B, nn, L, D)

    xt = x[:, None, :] - P_rows  # (B, L, D) x̃ per positive
    pred_i = (
        params["bi"][items_c]
        + jnp.einsum("bld,bld->bl", xt, Q_pos) * s_rated[:, None]
    )
    # ref fism_pair predicts the negative side with the plain rating rule
    # s(u,j) = bu+bi_j+ scale·x̃·q_j; bu cancels in the pair difference
    pred_j = (
        params["bi"][neg_c]
        + jnp.einsum("bld,bnld->bnl", xt, Q_neg) * s_rated[:, None, None]
    )  # (B, nn, L)
    diff = pred_i[:, None, :] - pred_j
    g = loss.gradient(diff, 1.0) * mask_f[:, None, :] * neg_valid  # (B,nn,L)
    g_sum = jnp.sum(g, axis=1)  # (B, L) total over neg slots per positive

    grads = {}
    if cfg.using_bias_term:
        grads["bi"] = (
            jnp.zeros_like(params["bi"])
            .at[items].add(
                g_sum + nn * lam * params["bi"][items_c] * mask_f,
                mode="drop",
            )
            .at[neg.reshape(B, Nn)].add(
                (-g + lam * params["bi"][neg_c] * mask_f[:, None, :])
                .reshape(B, Nn),
                mode="drop",
            )
        )

    # Q: qi_grad = g·x̃·s + λq_i ; qj_grad = −g·x̃·s + λq_j
    gq_i = (
        (g_sum * s_rated[:, None])[..., None] * xt
        + nn * lam * Q_pos
    ) * mask_f[..., None]
    gq_j = (
        -(g * s_rated[:, None, None])[..., None] * xt[:, None, :, :]
        + lam * Q_neg
    ) * mask_f[:, None, :, None]
    grads["Q"] = (
        jnp.zeros_like(params["Q"])
        .at[items].add(gq_i, mode="drop")
        .at[neg.reshape(B, Nn)].add(gq_j.reshape(B, Nn, D), mode="drop")
    )

    # P: each rated k≠i gets g·(q_i − q_j)·s + λp_k per pair instance
    dq = jnp.einsum("bnl,bld->bd", g, Q_pos) - jnp.einsum(
        "bnl,bnld->bd", g, Q_neg
    )  # Σ_pairs g·(q_i − q_j)
    self_term = jnp.einsum("bl,bld->bld", g_sum, Q_pos) - jnp.einsum(
        "bnl,bnld->bld", g, Q_neg
    )
    gp = (
        (dq[:, None, :] - self_term) * s_rated[:, None, None]
        + lam * P_rows
    ) * mask_f[..., None]
    grads["P"] = jnp.zeros_like(params["P"]).at[items].add(gp, mode="drop")

    params = _fism_adagrad(params, grads, lr, cfg)
    params["x"] = _refresh_x_rows(params, uids, items, mask_f, w)
    return params


class FISMPair(FISM):
    """Pairwise FISM (capability rebuilt from the reference's broken
    fism_pair.hpp; default LOG loss like BPR)."""

    name = "FISMPair"
    pairwise = True

    def __init__(self, config: Optional[FISMConfig] = None, **kw):
        if config is None and "loss" not in kw:
            kw["loss"] = "LOG"
        super().__init__(config, **kw)
