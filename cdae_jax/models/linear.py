"""Generic feature-group models: LinearModel, FactorModel, NegMF.

Reference: src/model/linear_model.hpp (+-inl), factor_model.hpp (+-inl),
src/model/recsys/neg_mf.hpp. These are the only models in the reference that
operate on the GLOBAL feature-index space (user/item/... groups flattened):

  LinearModel (linear_model-inl.hpp:25-68):
      s(x) = mean + Σ_f w_f x_f ; per-feature AdaGrad with accumulators
      initialized at ZERO (grad/sqrt(acc) after acc += g², so the first
      touch steps by sign(g)·lr).
  FactorModel (factor_model-inl.hpp:34-128): order-2 FM whose pairwise
      interactions only span features in DIFFERENT groups (:54-58):
      s(x) = mean + Σ_f w_f x_f + Σ_{f<f', g(f)≠g(f')} x_f x_f' v_f·v_f'
  NegMF (neg_mf.hpp): FactorModel over (user,item) instances + num_neg
      sampled negatives per positive, label −1 for LOG/HINGE else 0
      (neg_mf.hpp:79-95).

Batched form: instances live in GroupedInstances dense slots; the cross-group
interaction uses the O(F·D) identity
  Σ_{f≠f'} (v_f x_f)·(v_f' x_f') = ‖Σ_f v_f x_f‖² − Σ_f ‖v_f x_f‖²
restricted per group to subtract same-group pairs. Minibatch updates
scatter-add per-instance gradient contributions (per-touch λ·param as in the
reference) and apply one AdaGrad step per batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cdae_jax.data.dataset import Interactions
from cdae_jax.data.instances import GroupedInstances
from cdae_jax.models.base import ModelState, RecsysModel
from cdae_jax.ops import sampling
from cdae_jax.ops.losses import Loss
from cdae_jax.ops.penalties import Penalty


@dataclasses.dataclass(frozen=True)
class LinearModelConfig:
    """ref linear_model.hpp:12-21"""

    lambda_: float = 0.001
    loss: str = "SQUARE"
    penalty: str = "L2"
    using_global_mean: bool = True
    using_adagrad: bool = True
    learn_rate: float = 0.1
    batch_size: int = 4096
    dtype: Any = jnp.float32


@dataclasses.dataclass(frozen=True)
class FactorModelConfig:
    """ref factor_model.hpp:12-22"""

    lambda_: float = 0.01
    loss: str = "SQUARE"
    penalty: str = "L2"
    num_dim: int = 5
    using_bias_term: bool = True
    using_factor_term: bool = True
    using_global_mean: bool = True
    using_adagrad: bool = True
    learn_rate: float = 0.1
    num_neg: int = 5  # NegMF only (ref neg_mf.hpp:16)
    batch_size: int = 4096
    dense_mode: Optional[bool] = None  # NegMF only: full-catalog (B, I)
    # slab step (one matmul; see _negmf_dense_step). OPT-IN (None=off):
    # user-slab granularity gives ~30x fewer zero-init-AdaGrad steps per
    # epoch than the reference's per-instance cadence, so it needs ~3x the
    # epochs to reach the same R@10 (measured 1200x600: sparse 0.585 @ 20ep;
    # dense bs64 0.580 @ 60ep = oracle parity) — a throughput trade, not the
    # default parity path.
    dtype: Any = jnp.float32


def _zero_init_adagrad(p, a, g, lr, use):
    """AdaGrad with zero-initialized accumulators (ref
    linear_model-inl.hpp:58-63, factor_model-inl.hpp:100-121): accumulate
    then divide by sqrt(acc); untouched coordinates (g=0) are skipped."""
    if not use:
        return p - lr * g, a
    a2 = a + g * g
    step = jnp.where(a2 > 0, g / jnp.sqrt(jnp.maximum(a2, 1e-30)), 0.0)
    return p - lr * step, a2


class LinearModel(RecsysModel):
    name = "LinearModel"

    def __init__(self, config: Optional[LinearModelConfig] = None, **kw):
        self.cfg = config if config is not None else LinearModelConfig(**kw)
        self.loss = Loss.create(self.cfg.loss)
        self.penalty = Penalty.create(self.cfg.penalty)
        self._lr = self.cfg.learn_rate
        self._jit_step = jax.jit(
            functools.partial(_linear_step, cfg=self.cfg, loss=self.loss),
            donate_argnums=(0,),
        )

    def set_learn_rate(self, lr: float) -> None:
        self._lr = float(lr)

    def _instances(self, data) -> GroupedInstances:
        if isinstance(data, GroupedInstances):
            return data
        return GroupedInstances.from_interactions(data)

    def reset(self, data, seed: int = 0) -> ModelState:
        gi = self._instances(data)
        dt = self.cfg.dtype
        key = jax.random.PRNGKey(seed)
        params = {
            # DMatrix::Random()*0.01 (ref linear_model-inl.hpp:9)
            "w": jax.random.uniform(key, (gi.total_dim,), dt, -0.01, 0.01),
            "w_ag": jnp.zeros((gi.total_dim,), dt),
        }
        mean = float(np.mean(gi.labels)) if len(gi) else 0.0
        state = ModelState(
            params=params, padded=None,
            num_users=gi.group_dims[0] if gi.group_dims else 0,
            num_items=gi.group_dims[1] if len(gi.group_dims) > 1 else 0,
        )
        state.aux["instances"] = gi
        state.aux["global_mean"] = mean if self.cfg.using_global_mean else 0.0
        return state

    def train_one_iteration(self, state: ModelState, rng_key) -> ModelState:
        gi: GroupedInstances = state.aux["instances"]
        n = len(gi)
        bs = self.cfg.batch_size
        perm = np.random.default_rng(
            np.asarray(jax.random.key_data(rng_key))[-1]
        ).permutation(n)
        params = state.params
        mean = jnp.asarray(state.aux["global_mean"], self.cfg.dtype)
        for start in range(0, n, bs):
            sel = perm[start : start + bs]
            pad = bs - len(sel)
            w = np.ones(bs, dtype=np.float32)
            if pad > 0:
                w[bs - pad :] = 0.0
                sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
            params = self._jit_step(
                params,
                jnp.asarray(gi.idx[sel]),
                jnp.asarray(gi.vals[sel] * gi.mask[sel]),
                jnp.asarray(gi.labels[sel]),
                jnp.asarray(w),
                mean,
                jnp.asarray(self._lr, self.cfg.dtype),
            )
        state.params = params
        state.step += 1
        return state

    def data_loss(self, state, sample_size: int = 0) -> float:
        """Loss over the first ``sample_size`` instances (0 = all), matching
        the reference's subsampling knob (ref linear_model.hpp:45-59)."""
        gi: GroupedInstances = state.aux["instances"]
        if sample_size > 0:
            gi = gi.head(sample_size)
        preds = self._predict_instances(state, gi)
        return float(
            jnp.sum(self.loss.evaluate(preds, jnp.asarray(gi.labels)))
        )

    def penalty_loss(self, state) -> float:
        return float(
            0.5 * self.cfg.lambda_ * self.penalty.evaluate(state.params["w"])
        )

    def _predict_instances(self, state, gi: GroupedInstances):
        mean = state.aux["global_mean"]
        vals = jnp.asarray(gi.vals * gi.mask)
        return mean + jnp.sum(state.params["w"][jnp.asarray(gi.idx)] * vals, -1)

    def predict(self, state, users, items):
        gi: GroupedInstances = state.aux["instances"]
        u_off = 0
        i_off = gi.group_dims[0]
        u = jnp.asarray(users) + u_off
        i = jnp.asarray(items) + i_off
        w = state.params["w"]
        return state.aux["global_mean"] + w[u] + w[i]


def _linear_step(params, idx, vals, labels, w, mean, lr, *, cfg, loss):
    """ref linear_model-inl.hpp:46-68, batched."""
    pred = mean + jnp.sum(params["w"][idx] * vals, axis=-1)
    g = loss.gradient(pred, labels) * w
    contrib = g[:, None] * vals + cfg.lambda_ * params["w"][idx] * (
        (vals != 0).astype(vals.dtype) * w[:, None]
    )
    grad = jnp.zeros_like(params["w"]).at[idx].add(contrib)
    p, a = _zero_init_adagrad(
        params["w"], params["w_ag"], grad, lr, cfg.using_adagrad
    )
    out = dict(params)
    out["w"], out["w_ag"] = p, a
    return out


# ---------------------------------------------------------------- FactorModel


def _fm_forward(params, idx, vals, mean, group_of):
    """FM score with cross-group-only interactions
    (ref factor_model-inl.hpp:34-63)."""
    w_terms = jnp.sum(params["w"][idx] * vals, axis=-1)
    Vx = params["V"][idx] * vals[..., None]  # (B, F, D)
    total = jnp.sum(Vx, axis=1)  # (B, D)
    all_pairs = jnp.sum(total * total, -1) - jnp.sum(Vx * Vx, (-2, -1))
    # subtract same-group pairs
    same = jnp.zeros_like(all_pairs)
    for gid in sorted(set(group_of)):
        sel = [f for f, g in enumerate(group_of) if g == gid]
        if len(sel) < 2:
            continue
        sub = Vx[:, jnp.asarray(sel), :]
        s = jnp.sum(sub, axis=1)
        same = same + jnp.sum(s * s, -1) - jnp.sum(sub * sub, (-2, -1))
    return mean + w_terms + 0.5 * (all_pairs - same)


class FactorModel(LinearModel):
    name = "FactorModel"

    def __init__(self, config: Optional[FactorModelConfig] = None, **kw):
        cfg = config if config is not None else FactorModelConfig(**kw)
        self.cfg = cfg
        self.loss = Loss.create(cfg.loss)
        self.penalty = Penalty.create(cfg.penalty)
        self._lr = cfg.learn_rate
        self._jit_step = None  # built at reset (needs static group_of)

    def reset(self, data, seed: int = 0) -> ModelState:
        gi = self._instances(data)
        dt = self.cfg.dtype
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        T, D = gi.total_dim, self.cfg.num_dim
        params: Dict[str, jnp.ndarray] = {
            "w": jax.random.uniform(k1, (T,), dt, -0.01, 0.01),
            "w_ag": jnp.zeros((T,), dt),
            "V": jax.random.uniform(k2, (T, D), dt, -0.01, 0.01),
            "V_ag": jnp.zeros((T, D), dt),
        }
        mean = float(np.mean(gi.labels)) if len(gi) else 0.0
        state = ModelState(
            params=params, padded=None,
            num_users=gi.group_dims[0] if gi.group_dims else 0,
            num_items=gi.group_dims[1] if len(gi.group_dims) > 1 else 0,
        )
        state.aux["instances"] = gi
        state.aux["global_mean"] = mean if self.cfg.using_global_mean else 0.0
        self._jit_step = jax.jit(
            functools.partial(
                _fm_step, cfg=self.cfg, loss=self.loss, group_of=gi.group_of
            ),
            donate_argnums=(0,),
        )
        self._group_of = gi.group_of
        return state

    def data_loss(self, state, sample_size: int = 0) -> float:
        """First-``sample_size`` subsampled loss (ref factor_model.hpp:52-61)."""
        gi: GroupedInstances = state.aux["instances"]
        if sample_size > 0:
            gi = gi.head(sample_size)
        preds = self._predict_instances(state, gi)
        return float(jnp.sum(self.loss.evaluate(preds, jnp.asarray(gi.labels))))

    def penalty_loss(self, state) -> float:
        p = state.params
        return float(
            0.5
            * self.cfg.lambda_
            * (self.penalty.evaluate(p["w"]) + self.penalty.evaluate(p["V"]))
        )

    def _predict_instances(self, state, gi: GroupedInstances):
        return _fm_forward(
            state.params,
            jnp.asarray(gi.idx),
            jnp.asarray(gi.vals * gi.mask),
            state.aux["global_mean"],
            gi.group_of,
        )

    def predict(self, state, users, items):
        gi: GroupedInstances = state.aux["instances"]
        i_off = gi.group_dims[0]
        idx = jnp.stack(
            [jnp.asarray(users), jnp.asarray(items) + i_off], axis=1
        )
        vals = jnp.ones_like(idx, dtype=self.cfg.dtype)
        return _fm_forward(
            state.params, idx, vals, state.aux["global_mean"], gi.group_of
        )

    def batch_scores(self, state, uids, rated_items, rated_mask):
        """(B, I) catalog scores for TOPN eval: mean + w_u + w_i + v_u·v_i
        (the 2-group recsys case of the FM forward)."""
        gi: GroupedInstances = state.aux["instances"]
        i_off = gi.group_dims[0]
        p = state.params
        u = jnp.asarray(uids)
        I = state.num_items
        item_idx = jnp.arange(I) + i_off
        return (
            state.aux["global_mean"]
            + p["w"][u][:, None]
            + p["w"][item_idx][None, :]
            + p["V"][u] @ p["V"][item_idx].T
        )


def _fm_step(params, idx, vals, labels, w, mean, lr, *, cfg, loss, group_of):
    """Batched FM update (ref factor_model-inl.hpp:65-128): per-instance
    contributions with per-touch λ, one zero-init AdaGrad step per batch."""
    pred = _fm_forward(params, idx, vals, mean, group_of)
    g = loss.gradient(pred, labels) * w  # (B,)
    out = dict(params)

    if cfg.using_bias_term:
        contrib = g[:, None] * vals + cfg.lambda_ * params["w"][idx] * (
            (vals != 0).astype(vals.dtype) * w[:, None]
        )
        grad_w = jnp.zeros_like(params["w"]).at[idx].add(contrib)
        out["w"], out["w_ag"] = _zero_init_adagrad(
            params["w"], params["w_ag"], grad_w, lr, cfg.using_adagrad
        )

    if cfg.using_factor_term:
        Vx = params["V"][idx] * vals[..., None]  # (B, F, D)
        # dpred/dv_f = x_f · Σ_{f' : g(f')≠g(f)} v_f' x_f'
        F = idx.shape[1]
        groups = np.asarray(group_of)
        total = jnp.sum(Vx, axis=1)  # (B, D)
        per_group = {}
        for gid in sorted(set(group_of)):
            sel = [f for f in range(F) if groups[f] == gid]
            per_group[gid] = jnp.sum(Vx[:, jnp.asarray(sel), :], axis=1)
        other = jnp.stack(
            [total - per_group[groups[f]] for f in range(F)], axis=1
        )  # (B, F, D)
        touched = ((vals != 0).astype(vals.dtype) * w[:, None])[..., None]
        contrib_V = (
            g[:, None, None] * vals[..., None] * other
            + cfg.lambda_ * params["V"][idx] * touched
        )
        grad_V = jnp.zeros_like(params["V"]).at[idx].add(contrib_V)
        out["V"], out["V_ag"] = _zero_init_adagrad(
            params["V"], params["V_ag"], grad_V, lr, cfg.using_adagrad
        )
    return out


def _negmf_dense_step(params, R, uids, weight, mean, lr, key, *, cfg, loss,
                      i_off):
    """Full-catalog dense-slab NegMF step: in the 2-group recsys case the
    FM score is mean + w_u + w_i + v_u·v_i, so the whole (B, I) slab is one
    matmul and every scatter becomes a column reduction. Negatives are
    Bernoulli over the complement with E[count] = num_neg·|R_u| per user
    (the reference draws num_neg per positive, ref neg_mf.hpp:79-95 — same
    expected touches, the IMF-dense substitution). Per-touch λ follows
    _fm_step's conventions: each instance regularizes BOTH its touched
    features."""
    dt = params["V"].dtype
    w_user = weight.astype(dt)
    rows = R[uids].astype(dt) * w_user[:, None]  # (B, I)
    I = rows.shape[1]
    lengths = jnp.sum(rows, axis=1)
    p_neg = jnp.clip(
        cfg.num_neg * lengths / jnp.maximum(I - lengths, 1.0), 0.0, 1.0
    )
    u01 = jax.random.uniform(key, rows.shape)
    neg_sel = (
        (1.0 - rows) * (u01 < p_neg[:, None]).astype(dt) * w_user[:, None]
    )
    touch = rows + neg_sel
    neg_label = -1.0 if loss.name in ("LOG", "HINGE") else 0.0
    labels = jnp.where(rows > 0, loss.positive_label, neg_label)

    Vu = params["V"][uids]  # (B, D)
    Vi = params["V"][i_off:i_off + I]  # (I, D)
    wu = params["w"][uids]
    wi = params["w"][i_off:i_off + I]
    pred = mean + wu[:, None] + wi[None, :]
    if cfg.using_factor_term:
        pred = pred + Vu @ Vi.T
    g = loss.gradient(pred, labels) * touch  # (B, I)
    lam = cfg.lambda_
    touch_u = jnp.sum(touch, axis=1)  # (B,)
    touch_i = jnp.sum(touch, axis=0)  # (I,)
    out = dict(params)
    if cfg.using_bias_term:
        grad_w = jnp.zeros_like(params["w"])
        grad_w = grad_w.at[uids].add(jnp.sum(g, axis=1) + lam * wu * touch_u)
        grad_w = jax.lax.dynamic_update_slice(
            grad_w,
            jax.lax.dynamic_slice(grad_w, (i_off,), (I,))
            + jnp.sum(g, axis=0) + lam * wi * touch_i,
            (i_off,),
        )
        out["w"], out["w_ag"] = _zero_init_adagrad(
            params["w"], params["w_ag"], grad_w, lr, cfg.using_adagrad
        )
    if cfg.using_factor_term:
        grad_V = jnp.zeros_like(params["V"])
        grad_V = grad_V.at[uids].add(
            g @ Vi + lam * Vu * touch_u[:, None]
        )
        grad_V = jax.lax.dynamic_update_slice(
            grad_V,
            jax.lax.dynamic_slice(grad_V, (i_off, 0), (I, grad_V.shape[1]))
            + g.T @ Vu + lam * Vi * touch_i[:, None],
            (i_off, 0),
        )
        out["V"], out["V_ag"] = _zero_init_adagrad(
            params["V"], params["V_ag"], grad_V, lr, cfg.using_adagrad
        )
    return out


class NegMF(FactorModel):
    """FactorModel + per-positive negative sampling (ref neg_mf.hpp).
    Only defined over recsys (user, item) data; negatives carry label −1
    for LOG/HINGE losses, else 0 (ref neg_mf.hpp:84-90)."""

    name = "NegMF"

    def __init__(self, config: Optional[FactorModelConfig] = None, **kw):
        if config is None and "loss" not in kw:
            kw["loss"] = "LOG"
        super().__init__(config, **kw)
        self._jit_epoch = None
        self._epoch_batches = -1

    def reset(self, data, seed: int = 0) -> ModelState:
        if isinstance(data, GroupedInstances):
            raise ValueError("NegMF needs recsys Interactions data")
        state = super().reset(data, seed)
        state.padded = data.padded()
        state.aux["coo"] = (data.users, data.items)
        self._jit_epoch = None  # shapes may have changed
        U, I = state.num_users, state.num_items
        if self.cfg.dense_mode:
            state.aux["dense_R"] = (
                jnp.zeros((U, I), jnp.int8)
                .at[jnp.asarray(data.users), jnp.asarray(data.items)]
                .set(1)
            )
            gi = state.aux["instances"]
            self._jit_dense_step = jax.jit(
                functools.partial(
                    _negmf_dense_step, cfg=self.cfg, loss=self.loss,
                    i_off=int(gi.group_dims[0]),
                ),
                donate_argnums=(0,),
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

    # -- epoch: one fused device program (same rationale as _MFBase._build_
    # epoch): the per-batch host loop pays a dispatch + transfer per batch,
    # which leaves the device idle between batches. Shuffle, negative
    # sampling (ref neg_mf.hpp:79-95), and every FM update run in one scan.
    def _epoch_fn(self, num_batches: int, I: int, i_off: int,
                  constrain=None):
        cfg, loss = self.cfg, self.loss
        bs = cfg.batch_size
        nn = max(cfg.num_neg, 0)
        neg_label = (
            -1.0 if loss.name in ("LOG", "HINGE") else 0.0
        )  # ref neg_mf.hpp:84-90
        step = functools.partial(
            _fm_step, cfg=cfg, loss=loss, group_of=(0, 1)
        )

        def epoch(params, users, items, pad_items, pad_lengths, mean, lr,
                  key):
            n = users.shape[0]
            kperm, kstep = jax.random.split(key)
            perm = jax.random.permutation(kperm, n)
            total = num_batches * bs
            if total > n:
                perm = jnp.concatenate(
                    [perm, jnp.zeros((total - n,), perm.dtype)]
                )
            w_all = (jnp.arange(total) < n).astype(jnp.float32)
            sel_mat = perm.reshape(num_batches, bs)
            w_mat = w_all.reshape(num_batches, bs)

            def body(carry, inp):
                params, key = carry
                sel, w = inp
                if constrain is not None:  # shard the minibatch ('data' DP)
                    sel, w = constrain(sel), constrain(w)
                u = users[sel]
                it = items[sel]
                key, sub = jax.random.split(key)
                if nn > 0:
                    neg = sampling.sample_unrated(
                        sub, pad_items[u], pad_lengths[u], I, nn
                    )  # (B, nn)
                    # sentinel id I = empty complement -> zero-weight it
                    neg_valid = (neg < I).astype(jnp.float32)
                    neg_c = jnp.clip(neg, 0, I - 1)
                    all_u = jnp.tile(u[:, None], (1, nn + 1))
                    all_i = jnp.concatenate([it[:, None], neg_c], axis=1)
                    labels = jnp.concatenate(
                        [
                            jnp.full((bs, 1), loss.positive_label),
                            jnp.full((bs, nn), neg_label),
                        ],
                        axis=1,
                    )
                    idx = jnp.stack(
                        [all_u.reshape(-1), all_i.reshape(-1) + i_off],
                        axis=1,
                    )
                    vals = jnp.ones_like(idx, dtype=cfg.dtype)
                    ww = (
                        w[:, None]
                        * jnp.concatenate(
                            [jnp.ones((bs, 1), jnp.float32), neg_valid],
                            axis=1,
                        )
                    ).reshape(-1)
                    params = step(
                        params, idx, vals, labels.reshape(-1), ww, mean, lr
                    )
                else:
                    idx = jnp.stack([u, it + i_off], axis=1)
                    vals = jnp.ones_like(idx, dtype=cfg.dtype)
                    params = step(
                        params, idx, vals,
                        jnp.full((bs,), loss.positive_label), w, mean, lr,
                    )
                return (params, key), None

            (params, _), _ = jax.lax.scan(body, (params, kstep),
                                          (sel_mat, w_mat))
            return params

        return epoch

    def _build_epoch(self, num_batches: int, I: int, i_off: int):
        return jax.jit(self._epoch_fn(num_batches, I, i_off),
                       donate_argnums=(0,))

    def train_one_iteration(self, state: ModelState, rng_key) -> ModelState:
        if "dense_R" in state.aux:
            R = state.aux["dense_R"]
            uid_mat, w_mat = self._dense_user_batches(state)
            mean = jnp.asarray(state.aux["global_mean"], self.cfg.dtype)
            lr = jnp.asarray(self._lr, self.cfg.dtype)
            params = state.params
            for j in range(uid_mat.shape[0]):
                rng_key, sub = jax.random.split(rng_key)
                params = self._jit_dense_step(
                    params, R, uid_mat[j], w_mat[j], mean, lr, sub
                )
            state.params = params
            state.step += 1
            return state
        gi: GroupedInstances = state.aux["instances"]
        n = len(gi)
        num_batches = max(-(-n // self.cfg.batch_size), 1)
        if self._jit_epoch is None or self._epoch_batches != num_batches:
            self._jit_epoch = self._build_epoch(
                num_batches, state.num_items, int(gi.group_dims[0])
            )
            self._epoch_batches = num_batches
        if "device_data" not in state.aux:
            users, items = state.aux["coo"]
            pb = state.padded
            state.aux["device_data"] = (
                jnp.asarray(users), jnp.asarray(items),
                jnp.asarray(pb.items), jnp.asarray(pb.lengths),
            )
        du, di, dpi, dpl = state.aux["device_data"]
        state.params = self._jit_epoch(
            state.params, du, di, dpi, dpl,
            jnp.asarray(state.aux["global_mean"], self.cfg.dtype),
            jnp.asarray(self._lr, self.cfg.dtype),
            rng_key,
        )
        state.step += 1
        return state

    def data_loss(self, state, sample_size: int = 0) -> float:
        return 0.0  # ref neg_mf.hpp:64-66 (sample_size accepted, unused)

    def penalty_loss(self, state) -> float:
        return 0.0
