"""Matrix-factorization model family: PMF, IMF, BPR, WARP.

Batched re-implementations of the reference's sequential per-instance SGD
models (ref: src/model/recsys/pmf.hpp, imf.hpp, bpr.hpp, warp.hpp). All four
share the parameter layout {uv (U,D), iv (I,D), ub (U,), ib (I,)} with
AdaGrad accumulators (init 1e-4, ref pmf.hpp:61-65) and the scoring rule
  s(u,i) = ub_u + ib_i + uv_u · iv_i            (ref pmf.hpp:107-109)

Architecture change vs the reference (SURVEY §7): the reference walks users
sequentially and updates rows in place per instance (e.g. imf.hpp:71-85);
here each epoch processes shuffled fixed-size minibatches of (user, item)
instances, samples negatives ON DEVICE via exact complement sampling
(ops/sampling.py, replacing the rejection loop recsys_model_base.hpp:46-70),
scatter-adds per-instance gradient contributions (including the reference's
per-touch 2λ regularization terms) and applies one AdaGrad step per batch.
Parity is judged on ranking metrics, not bitwise trajectory.

  PMF  — observed-ratings MF (ref pmf.hpp:80-104)
  IMF  — implicit MF: each positive + num_neg sampled negatives
         (ref imf.hpp:71-115)
  BPR  — pairwise ranking on s(u,i)−s(u,j), LOG loss, no user-bias update
         (ref bpr.hpp:60-106)
  WARP — rank-weighted pairwise: first violating negative out of a bounded
         candidate set, weight l[items_left/cnt] (ref warp.hpp:55-117;
         the reference's 500-try rejection loop becomes a fixed num_tries
         candidate scan — first-violator semantics preserved)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cdae_jax.data.dataset import Interactions
from cdae_jax.models.base import ModelState, RecsysModel
from cdae_jax.ops import sampling
from cdae_jax.ops.scatter import scatter_add_rows
from cdae_jax.ops.losses import Loss
from cdae_jax.ops.penalties import Penalty
from cdae_jax.solver.optimizer import (
    ADAGRAD_INIT,
    dense_adagrad_step,
    row_adagrad_delta,
)


@dataclasses.dataclass(frozen=True)
class MFConfig:
    """Shared config surface of PMFConfig/IMFConfig/BPRConfig/WARPConfig
    (ref pmf.hpp:12-22, imf.hpp:12-23, bpr.hpp:12-23, warp.hpp:12-23)."""

    learn_rate: float = 0.1
    beta: float = 1.0
    lambda_: float = 0.01
    loss: str = "SQUARE"
    penalty: str = "L2"
    num_dim: int = 10
    num_neg: int = 5
    using_bias_term: bool = True
    using_adagrad: bool = True
    # --- build knobs ---
    batch_size: int = 1024  # instances per synchronous minibatch
    num_tries: int = 64  # WARP only: candidate negatives scanned per update
    dense_mode: Optional[bool] = None  # PMF/IMF: full-catalog dense
    # slabs instead of scatter-adds; Bernoulli complement negatives with
    # E[count]=num_neg per positive. None = auto when the (U, I) matrix
    # fits device memory. BPR: per-USER dense slab with num_shared_neg
    # shared negatives (see BPR._dense_step) — opt-in (None = off) until
    # its parity cell is recorded. WARP ignores it
    # for training (its dense violator path is a separate mechanism).
    num_shared_neg: int = 32  # BPR dense slab only: M shared negative
    # draws per user per epoch, drawn uniform over the CATALOG with rated
    # hits zero-weighted; surviving pairs are reweighted num_neg/M_live
    # (M_live = unrated draws). If ALL M draws land on rated items, one
    # exact rank-select rescue draw (the u-th zero of the dense row) is
    # substituted via lax.cond so the user still contributes — no
    # fully-dead users, though individual rated draws are still dropped.
    # Each positive pairs with the shared live draws — an unbiased
    # estimator of the reference's num_neg independent per-positive
    # complement draws (same conditional distribution given liveness),
    # with lower per-positive variance and every gather/scatter
    # restructured into (B,I)x(I,D) matmuls. Users with an empty
    # complement (rated the whole catalog) contribute nothing, as in the
    # reference.
    row_update: Optional[bool] = None  # sparse steps: update ONLY the
    # touched parameter rows via duplicate-safe delta AdaGrad
    # (solver/optimizer.row_adagrad_delta — the CDAE sparse path's scheme)
    # instead of materializing full (I, C)/(U, D) gradient tables and a
    # dense accumulate-then-apply pass. O(B·(1+nn)) per step, independent
    # of catalog size. Semantics: per-contribution AdaGrad (duplicates within a
    # batch see partially-stale accumulators — CLOSER to the reference's
    # sequential per-pair updates than accumulate-then-apply). None = auto
    # (on when the item count exceeds ~128k).
    epoch_chunk: Optional[int] = None  # max scan steps per device dispatch.
    # None = the whole epoch is ONE fused program (default). At
    # huge-catalog shapes set a chunk (e.g. 64) to bound each dispatch's
    # length, with a forced readback between chunks so dispatches can't
    # pile up.
    warp_pool: Optional[int] = None  # WARP only: pooled candidate
    # negatives — per step draw ONE shared pool of P uniform item ids,
    # score it with a single (B,D)x(D,P) matmul, and run the closed-form
    # rejection process against POOL violators (p̂ = pool violator
    # fraction among unrated pool entries; selection uniform over pool
    # violators). O(B·P·nn) per step instead of the dense path's
    # O(B·I·nn): the estimator of the reference's process under pool
    # sampling variance (same construction as CDAEConfig.neg_pool).
    # None = off (dense violator path). Works in BOTH regimes: with the
    # dense (U, I) rated mask when it exists, and at huge catalogs
    # (dense_mode=False or U·I > 1.5e9) via a CSR-gathered pool membership
    # test (ops/sampling.is_rated) — same truth table, bitwise-identical
    # trajectory at equal keys.
    scatter_mode: str = "auto"  # auto|matmul|scatter — how per-instance
    # gradient rows are aggregated into the parameter tables; "matmul"
    # routes them through one-hot matmuls (ops/scatter.py). "auto" picks
    # matmul whenever its FLOP cost is in budget (always, at MF-family
    # shapes).
    dtype: Any = jnp.float32


def _init_mf_params(key, U, I, D, dt, scale=0.01):
    """U(-scale, scale) factors + zero biases + 1e-4 accumulators
    (ref pmf.hpp:55-65: DMatrix::Random()*0.01 is uniform in (-0.01,0.01))."""
    k1, k2 = jax.random.split(key)
    at = jnp.float32  # optimizer state stays f32 (see solver/optimizer.py)
    return {
        "uv": jax.random.uniform(k1, (U, D), dt, -scale, scale),
        "iv": jax.random.uniform(k2, (I, D), dt, -scale, scale),
        "ub": jnp.zeros((U,), dt),
        "ib": jnp.zeros((I,), dt),
        "uv_ag": jnp.full((U, D), ADAGRAD_INIT, at),
        "iv_ag": jnp.full((I, D), ADAGRAD_INIT, at),
        "ub_ag": jnp.full((U,), ADAGRAD_INIT, at),
        "ib_ag": jnp.full((I,), ADAGRAD_INIT, at),
    }


def _adagrad_apply(params, grads, cfg: MFConfig):
    """One dense accumulate-then-apply AdaGrad step per minibatch."""
    out = dict(params)
    for name, g in grads.items():
        out[name], out[name + "_ag"] = dense_adagrad_step(
            params[name], params[name + "_ag"], g, cfg.learn_rate, cfg.beta,
            cfg.using_adagrad,
        )
    return out


def _pointwise_contribs(uv_u, iv_i, ub_u, ib_i, labels, w, cfg: MFConfig,
                        loss: Loss):
    """Pointwise update math on PRE-GATHERED rows (ref pmf.hpp:80-104):
    g = loss'(s(u,i), y); each touch adds its own 2λ·param regularization
    term. Shared by `_pointwise_grads` (full-table gathers) and the
    tensor-parallel trainer (parallel/tp_pairwise.py, 'model'-sharded item
    blocks). Returns per-instance contribution rows
    (d_uv (P, D), d_iv (P, D), d_ub (P,), d_ib (P,))."""
    lam2 = 2.0 * cfg.lambda_
    pred = ub_u + ib_i + jnp.sum(uv_u * iv_i, axis=-1)
    g = loss.gradient(pred, labels) * w
    d_uv = g[:, None] * iv_i + (lam2 * uv_u) * w[:, None]
    d_iv = g[:, None] * uv_u + (lam2 * iv_i) * w[:, None]
    d_ub = g + lam2 * ub_u * w
    d_ib = g + lam2 * ib_i * w
    return d_uv, d_iv, d_ub, d_ib


def _use_row_update(cfg: MFConfig, num_items: int) -> bool:
    if cfg.row_update is not None:
        return cfg.row_update
    return num_items > 131072


def _pointwise_apply(params, u, i, labels, w, cfg: MFConfig, loss: Loss):
    """One pointwise minibatch update: full-table accumulate-then-apply
    AdaGrad, or O(P) touched-rows delta AdaGrad for huge catalogs."""
    if not _use_row_update(cfg, params["iv"].shape[0]):
        return _adagrad_apply(
            params, _pointwise_grads(params, u, i, labels, w, cfg, loss),
            cfg,
        )
    d_uv, d_iv, d_ub, d_ib = _pointwise_contribs(
        params["uv"][u], params["iv"][i], params["ub"][u], params["ib"][i],
        labels, w, cfg, loss,
    )
    live = w > 0
    out = dict(params)
    out["uv"], out["uv_ag"] = row_adagrad_delta(
        params["uv"], params["uv_ag"], u, d_uv, live[:, None],
        cfg.learn_rate, cfg.beta, cfg.using_adagrad)
    out["iv"], out["iv_ag"] = row_adagrad_delta(
        params["iv"], params["iv_ag"], i, d_iv, live[:, None],
        cfg.learn_rate, cfg.beta, cfg.using_adagrad)
    if cfg.using_bias_term:
        out["ub"], out["ub_ag"] = row_adagrad_delta(
            params["ub"], params["ub_ag"], u, d_ub, live,
            cfg.learn_rate, cfg.beta, cfg.using_adagrad)
        out["ib"], out["ib_ag"] = row_adagrad_delta(
            params["ib"], params["ib_ag"], i, d_ib, live,
            cfg.learn_rate, cfg.beta, cfg.using_adagrad)
    return out


def _pointwise_grads(params, u, i, labels, w, cfg: MFConfig, loss: Loss):
    """Per-instance contributions of the PMF/IMF update rule, aggregated
    into full tables (math in _pointwise_contribs)."""
    d_uv, d_iv, d_ub, d_ib = _pointwise_contribs(
        params["uv"][u], params["iv"][i], params["ub"][u], params["ib"][i],
        labels, w, cfg, loss,
    )
    sm = cfg.scatter_mode
    grads = {
        "uv": scatter_add_rows(jnp.zeros_like(params["uv"]), u, d_uv,
                               mode=sm),
        "iv": scatter_add_rows(jnp.zeros_like(params["iv"]), i, d_iv,
                               mode=sm),
    }
    if cfg.using_bias_term:
        grads["ub"] = scatter_add_rows(jnp.zeros_like(params["ub"]), u,
                                       d_ub, mode=sm)
        grads["ib"] = scatter_add_rows(jnp.zeros_like(params["ib"]), i,
                                       d_ib, mode=sm)
    return grads


class _MFBase(RecsysModel):
    """Shared reset/scoring/loss plumbing for the MF family."""

    dense_capable = False  # subclasses with a _dense_step opt in
    dense_auto = True  # dense_mode=None => auto-on when it fits HBM;
    # False = opt-in only (BPR: slab cadence trades AdaGrad steps for
    # matmul throughput — kept explicit until measured per workload)
    uses_ratings = False

    def __init__(self, config: Optional[MFConfig] = None, **kw):
        self.cfg = config if config is not None else MFConfig(**kw)
        self.loss = Loss.create(self.cfg.loss)
        self.penalty = Penalty.create(self.cfg.penalty)
        self._jit_step = jax.jit(
            functools.partial(self._step, cfg=self.cfg, loss=self.loss),
            donate_argnums=(0,),
        )
        self._jit_dense_step = jax.jit(
            functools.partial(self._dense_step, cfg=self.cfg, loss=self.loss),
            donate_argnums=(0,),
        ) if self.dense_capable else None
        self._jit_scores = jax.jit(_mf_batch_scores)
        self._jit_loss = jax.jit(
            functools.partial(_mf_data_loss, loss=self.loss)
        )
        self._jit_epoch = None  # built lazily (needs static num_batches)
        self._jit_epoch_ext = None  # chunked-epoch variant (epoch_chunk)
        self._epoch_ext_chunk = -1
        self._jit_dense_epoch = None  # fused dense-slab epoch scan

    def reset(self, data: Interactions, seed: int = 0) -> ModelState:
        U, I = data.num_users, data.num_items
        params = _init_mf_params(
            jax.random.PRNGKey(seed), U, I, self.cfg.num_dim, self.cfg.dtype
        )
        state = ModelState(params=params, padded=data.padded(),
                           num_users=U, num_items=I)
        state.aux["coo"] = (data.users, data.items, data.ratings)
        dense = self.cfg.dense_mode
        if dense is None:
            dense = (
                self.dense_capable
                and self.dense_auto
                and U * I <= 1_500_000_000
                and self.cfg.batch_size * I * 40 <= 4_000_000_000
            )
        if dense and self.dense_capable:
            # on-device build from COO (ships nnz*8 bytes, not U*I)
            state.aux["dense_R"] = (
                jnp.zeros((U, I), jnp.int8)
                .at[jnp.asarray(data.users), jnp.asarray(data.items)]
                .set(1)
            )
            if self.uses_ratings:
                # host build keeps the reference's first-occurrence-wins
                # duplicate semantics (device scatter order is undefined)
                state.aux["dense_ratings"] = jnp.asarray(
                    data.dense_matrix(binary=False)
                )
        return state

    # -- epoch: one fused device program --------------------------------------
    # The whole epoch (on-device shuffle -> lax.scan over fixed-size instance
    # minibatches) runs as ONE dispatch; the reference's per-instance loop
    # (e.g. imf.hpp:71-85) would leave the device idle on host overhead.
    def _epoch_fn(self, num_batches: int, constrain=None,
                  external_perm: bool = False):
        """The raw (unjitted) fused-epoch function.

        ``external_perm``: take the shuffled (num_batches, bs) selection /
        weight matrices as ARGUMENTS instead of permuting inside — the
        sharded trainer feeds them PHYSICALLY sharded over the 'data' mesh
        axis. This is what actually forces data parallelism: a
        with_sharding_constraint on values derived from replicated inputs
        is elidable (GSPMD can satisfy it with a free slice and replicate
        all downstream compute — measured: zero collectives); a physically
        distributed input is not. ``constrain`` additionally re-asserts the
        batch sharding on the gathered tensors inside the scan body."""
        step = functools.partial(self._step, cfg=self.cfg, loss=self.loss)
        bs = self.cfg.batch_size

        def run_scan(params, users, items, ratings, pad_items, pad_lengths,
                     sel_mat, w_mat, kstep, extras):
            # per-step keys pre-split in ONE vectorized threefry call (an
            # in-scan split would serialize a small kernel per step)
            subs = jax.random.split(kstep, sel_mat.shape[0])

            def body(params, inp):
                sel, w, sub = inp
                u = users[sel]
                it, rt = items[sel], ratings[sel]
                pu, pl = pad_items[u], pad_lengths[u]
                ex = [e[u] for e in extras]  # per-user aux rows (e.g. the
                # dense rated mask WARP's violator counting needs)
                if constrain is not None:
                    u, it, rt, w = map(constrain, (u, it, rt, w))
                    pu, pl = constrain(pu), constrain(pl)
                    ex = [constrain(e) for e in ex]
                params = step(params, u, it, rt, w, pu, pl, sub, *ex)
                return params, None

            params, _ = jax.lax.scan(body, params,
                                     (sel_mat, w_mat, subs))
            return params

        if external_perm:
            def epoch_ext(params, users, items, ratings, pad_items,
                          pad_lengths, sel_mat, w_mat, key, *extras):
                return run_scan(params, users, items, ratings, pad_items,
                                pad_lengths, sel_mat, w_mat, key, extras)

            return epoch_ext

        def epoch(params, users, items, ratings, pad_items, pad_lengths, key,
                  *extras):
            n = users.shape[0]
            kperm, kstep = jax.random.split(key)
            perm = jax.random.permutation(kperm, n)
            total = num_batches * bs
            pad = total - n
            if pad > 0:
                perm = jnp.concatenate(
                    [perm, jnp.zeros((pad,), perm.dtype)]
                )
            w_all = (jnp.arange(total) < n).astype(jnp.float32)
            sel_mat = perm.reshape(num_batches, bs)
            w_mat = w_all.reshape(num_batches, bs)
            return run_scan(params, users, items, ratings, pad_items,
                            pad_lengths, sel_mat, w_mat, kstep, extras)

        return epoch

    def _build_epoch(self, num_batches: int):
        return jax.jit(self._epoch_fn(num_batches), donate_argnums=(0,))

    def _epoch_extras(self, state: ModelState) -> tuple:
        """Per-user auxiliary device arrays threaded into _step (row-gathered
        by user id inside the fused epoch). Default none."""
        return ()

    def _device_data(self, state: ModelState):
        if "device_data" not in state.aux:
            users, items, ratings = state.aux["coo"]
            pb = state.padded
            state.aux["device_data"] = (
                jnp.asarray(users), jnp.asarray(items), jnp.asarray(ratings),
                jnp.asarray(pb.items), jnp.asarray(pb.lengths),
            )
        return state.aux["device_data"]

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
        if "dense_R" in state.aux and self._jit_dense_step is not None:
            R = state.aux["dense_R"]
            ratings = state.aux.get("dense_ratings", R)
            uid_mat, w_mat = self._dense_user_batches(state)
            # fused dense epoch: ONE device program scans the user slabs
            # instead of one dispatch per slab
            if self._jit_dense_epoch is None:
                step = functools.partial(self._dense_step, cfg=self.cfg,
                                         loss=self.loss)

                def dense_epoch(params, R, ratings, uid_mat, w_mat, key):
                    subs = jax.random.split(key, uid_mat.shape[0])

                    def body(params, inp):
                        uids, w, sub = inp
                        return step(params, R, ratings, uids, w, sub), None

                    params, _ = jax.lax.scan(
                        body, params, (uid_mat, w_mat, subs)
                    )
                    return params

                self._jit_dense_epoch = jax.jit(dense_epoch,
                                                donate_argnums=(0,))
            state.params = self._jit_dense_epoch(
                state.params, R, ratings, uid_mat, w_mat, rng_key
            )
            state.step += 1
            return state
        n = len(state.aux["coo"][0])
        num_batches = max(-(-n // self.cfg.batch_size), 1)
        chunk = self.cfg.epoch_chunk
        users, items, ratings, pad_items, pad_lengths = self._device_data(state)
        if chunk and chunk < num_batches:
            state.params = self._chunked_epoch(
                state, num_batches, chunk, users, items, ratings,
                pad_items, pad_lengths, rng_key,
            )
            state.step += 1
            return state
        if self._jit_epoch is None or self._epoch_batches != num_batches:
            self._jit_epoch = self._build_epoch(num_batches)
            self._epoch_batches = num_batches
        state.params = self._jit_epoch(
            state.params, users, items, ratings, pad_items, pad_lengths,
            rng_key, *self._epoch_extras(state),
        )
        state.step += 1
        return state

    def _chunked_epoch(self, state, num_batches, chunk, users, items,
                       ratings, pad_items, pad_lengths, rng_key):
        """Epoch as ceil(num_batches/chunk) bounded device programs.

        Same semantics as the fused epoch (one on-device shuffle, scan over
        fixed-size minibatches) but the scan is sliced into `chunk`-step
        dispatches with a forced readback between them — no single device
        program grows with the dataset (a readback-free dispatch QUEUE
        would act as one long program)."""
        bs = self.cfg.batch_size
        n = users.shape[0]
        nchunks = -(-num_batches // chunk)
        total = nchunks * chunk * bs
        kperm, kstep = jax.random.split(rng_key)
        perm = jax.random.permutation(kperm, n)
        if total > n:
            perm = jnp.concatenate(
                [perm, jnp.zeros((total - n,), perm.dtype)]
            )
        w_all = (jnp.arange(total) < n).astype(jnp.float32)
        sel_mat = perm.reshape(nchunks, chunk, bs)
        w_mat = w_all.reshape(nchunks, chunk, bs)
        if self._jit_epoch_ext is None or self._epoch_ext_chunk != chunk:
            self._jit_epoch_ext = jax.jit(
                self._epoch_fn(chunk, external_perm=True),
                donate_argnums=(0,),
            )
            self._epoch_ext_chunk = chunk
        params = state.params
        extras = self._epoch_extras(state)
        for c in range(nchunks):
            params = self._jit_epoch_ext(
                params, users, items, ratings, pad_items, pad_lengths,
                sel_mat[c], w_mat[c], jax.random.fold_in(kstep, c), *extras,
            )
            # forced readback: bound the in-flight program chain
            float(jnp.sum(params[next(iter(params))]))
        return params

    # -- losses ---------------------------------------------------------------
    def data_loss(self, state: ModelState, sample_size: int = 0) -> float:
        # sample_size accepted-and-ignored (the reference MF family inherits
        # ModelBase's no-op data_loss; ours computing a real loss is already
        # a superset — model_base.hpp:35-39)
        users, items, ratings = state.aux["coo"]
        return float(
            self._jit_loss(
                state.params,
                jnp.asarray(users),
                jnp.asarray(items),
                jnp.asarray(ratings),
            )
        )

    def penalty_loss(self, state: ModelState) -> float:
        p = state.params
        pen = self.penalty.evaluate
        total = pen(p["uv"]) + pen(p["iv"]) + pen(p["ub"]) + pen(p["ib"])
        return float(self.cfg.lambda_ * total)

    # -- scoring --------------------------------------------------------------
    def batch_scores(self, state, uids, rated_items, rated_mask):
        return self._jit_scores(state.params, jnp.asarray(uids))

    def predict(self, state, users, items):
        p = state.params
        u = jnp.asarray(users)
        i = jnp.asarray(items)
        return p["ub"][u] + p["ib"][i] + jnp.sum(p["uv"][u] * p["iv"][i], -1)


def _mf_batch_scores(params, uids):
    return (
        params["ub"][uids][:, None]
        + params["ib"][None, :]
        + params["uv"][uids] @ params["iv"].T
    )


def _mf_data_loss(params, u, i, r, *, loss: Loss):
    pred = params["ub"][u] + params["ib"][i] + jnp.sum(
        params["uv"][u] * params["iv"][i], axis=-1
    )
    return jnp.sum(loss.evaluate(pred, r))


def _dense_mf_grads(params, rows, labels, w_mat, uids, w_user, cfg, loss):
    """Dense-slab version of _pointwise_grads: the (B, I) touch matrix
    ``w_mat`` carries per-(user,item) multiplicities; every gather/scatter
    becomes a matmul (ref update rule pmf.hpp:80-104 / imf.hpp:86-115)."""
    lam2 = 2.0 * cfg.lambda_
    uv_u = params["uv"][uids]  # (B, D)
    pred = (
        params["ub"][uids][:, None]
        + params["ib"][None, :]
        + uv_u @ params["iv"].T
    )
    # select the TRUTH slab, then one gradient eval — bitwise equal to
    # where(rows>0, grad(pred, labels), grad(pred, neg_label)) (gradients
    # are elementwise in (pred, truth)) at half the gradient passes over
    # the (B, I) slab (see the CDAE dense step's identical fusion)
    truth = jnp.where(rows > 0, labels,
                      jnp.asarray(loss.negative_label, pred.dtype))
    g = loss.gradient(pred, truth) * w_mat
    row_touch = jnp.sum(w_mat, axis=1)  # (B,) touches per user
    col_touch = jnp.sum(w_mat, axis=0)  # (I,)
    d_uv_rows = g @ params["iv"] + lam2 * row_touch[:, None] * uv_u
    d_iv = g.T @ uv_u + lam2 * col_touch[:, None] * params["iv"]
    grads = {"iv": d_iv}
    row_grads = {"uv": d_uv_rows}
    if cfg.using_bias_term:
        grads["ib"] = jnp.sum(g, 0) + lam2 * col_touch * params["ib"]
        row_grads["ub"] = jnp.sum(g, 1) + lam2 * row_touch * params["ub"][uids]
    return grads, row_grads


def _dense_row_apply(params, row_grads, uids, w_user, cfg):
    """Per-user-row AdaGrad via the shared duplicate-safe delta-add."""
    out = dict(params)
    for name, g in row_grads.items():
        live = (w_user > 0)[:, None] if g.ndim == 2 else (w_user > 0)
        out[name], out[name + "_ag"] = row_adagrad_delta(
            out[name], out[name + "_ag"], uids, g, live,
            cfg.learn_rate, cfg.beta, cfg.using_adagrad,
        )
    return out


class PMF(_MFBase):
    """Rating MF over observed entries (ref pmf.hpp)."""

    name = "PMF"
    dense_capable = True
    uses_ratings = True

    @staticmethod
    def _step(params, u, i, r, w, rated, lengths, key, *, cfg, loss):
        return _pointwise_apply(params, u, i, r, w, cfg, loss)

    @staticmethod
    def _dense_step(params, R, ratings, uids, weight, key, *, cfg, loss):
        w_user = weight.astype(params["uv"].dtype)
        rows = R[uids].astype(params["uv"].dtype) * w_user[:, None]
        labels = ratings[uids]
        grads, row_grads = _dense_mf_grads(
            params, rows, labels, rows, uids, w_user, cfg, loss
        )
        params = _adagrad_apply(params, grads, cfg)
        return _dense_row_apply(params, row_grads, uids, w_user, cfg)


class IMF(_MFBase):
    """Implicit MF: positive + num_neg sampled negatives per instance
    (ref imf.hpp:71-115). Labels use the loss's conventions
    (positive_label/negative_label, ref imf.hpp:79-82)."""

    name = "IMF"
    dense_capable = True
    uses_ratings = False

    @staticmethod
    def _dense_step(params, R, ratings, uids, weight, key, *, cfg, loss):
        dt = params["uv"].dtype
        w_user = weight.astype(dt)
        rows = R[uids].astype(dt) * w_user[:, None]
        I = rows.shape[1]
        lengths = jnp.sum(rows, axis=1)
        # Bernoulli complement negatives, E[count] = num_neg·|O_u|
        p_neg = jnp.clip(
            cfg.num_neg * lengths / jnp.maximum(I - lengths, 1.0), 0.0, 1.0
        )
        u = jax.random.uniform(key, rows.shape)
        neg_sel = (
            (1.0 - rows) * (u < p_neg[:, None]).astype(dt) * w_user[:, None]
        )
        w_mat = rows + neg_sel
        labels = jnp.full_like(rows, loss.positive_label)
        grads, row_grads = _dense_mf_grads(
            params, rows, labels, w_mat, uids, w_user, cfg, loss
        )
        params = _adagrad_apply(params, grads, cfg)
        return _dense_row_apply(params, row_grads, uids, w_user, cfg)

    @staticmethod
    def _step(params, u, i, r, w, rated, lengths, key, *, cfg, loss):
        B = u.shape[0]
        I = params["iv"].shape[0]
        nn = max(cfg.num_neg, 0)
        if nn > 0:
            neg = sampling.sample_unrated(key, rated, lengths, I, nn)  # (B,nn)
            all_u = jnp.concatenate([u[:, None], jnp.tile(u[:, None], (1, nn))], 1)
            all_i = jnp.concatenate([i[:, None], neg], axis=1)
            labels = jnp.concatenate(
                [
                    jnp.full((B, 1), loss.positive_label),
                    jnp.full((B, nn), loss.negative_label),
                ],
                axis=1,
            )
            # sentinel id I = empty complement -> zero-weight those slots
            all_w = jnp.tile(w[:, None], (1, nn + 1)) * (
                all_i < I
            ).astype(w.dtype)
            return _pointwise_apply(
                params,
                all_u.reshape(-1),
                jnp.clip(all_i, 0, I - 1).reshape(-1),
                labels.reshape(-1),
                all_w.reshape(-1),
                cfg,
                loss,
            )
        return _pointwise_apply(
            params, u, i, jnp.full_like(r, loss.positive_label), w, cfg, loss
        )


def _pair_contribs(uv_u, iv_i, iv_j, ib_i, ib_j, w, cfg, loss,
                   rank_weight=None, update_bias=True):
    """Pair-update math on PRE-GATHERED rows (ref bpr.hpp:72-106,
    warp.hpp:90-117): g = loss'(s(u,i)−s(u,j), 1) [·rank_weight].

    Shared by the single-device `_pairwise_grads` (which gathers from the
    full tables) and the tensor-parallel trainer (which reconstructs rows
    from 'model'-sharded table blocks, parallel/tp_pairwise.py). Returns
    (d_uv_rows (B, D), pos_vals (B, C), neg_vals (B, nn, C), with_bias)
    where C = D (+1 bias column when with_bias)."""
    lam2 = 2.0 * cfg.lambda_
    pred = (
        ib_i[:, None] - ib_j
        + jnp.sum(uv_u[:, None, :] * (iv_i[:, None, :] - iv_j), axis=-1)
    )  # (B, nn)
    g = loss.gradient(pred, 1.0) * w
    if rank_weight is not None:
        g = g * rank_weight
    gsum = jnp.sum(g, axis=1)  # (B,)
    wsum = jnp.sum(w, axis=1)
    d_uv_rows = (
        jnp.sum(g[..., None] * (iv_i[:, None, :] - iv_j), axis=1)
        + (lam2 * uv_u) * wsum[:, None]
    )
    pos_vals = gsum[:, None] * uv_u + (lam2 * iv_i) * wsum[:, None]  # (B, D)
    neg_vals = (
        -g[..., None] * uv_u[:, None, :] + (lam2 * iv_j) * w[..., None]
    )  # (B, nn, D)
    with_bias = update_bias and cfg.using_bias_term
    if with_bias:
        pos_vals = jnp.concatenate(
            [pos_vals, (gsum + lam2 * ib_i * wsum)[:, None]], axis=1
        )
        neg_vals = jnp.concatenate(
            [neg_vals, (-g + lam2 * ib_j * w)[..., None]], axis=2
        )
    return d_uv_rows, pos_vals, neg_vals, with_bias


def _pairwise_grads(params, u, i, j, w, cfg, loss, rank_weight=None,
                    update_bias=True):
    """BPR/WARP pair update contributions, aggregated into full tables.

    Shapes exploit the pair structure: u, i are (B,) and each pairs with
    nn negatives j (B, nn) [weights w / rank_weight (B, nn)]. The u- and
    i-side contributions of a row's nn pairs sum in registers (a reshape
    away — per-touch 2λ terms included per pair, exactly the reference's
    per-pair accumulation), so the expensive row-aggregation only sees
      u-side:  B rows    i-side: B rows    j-side: B·nn rows
    instead of B·nn everywhere — ~4x less scatter work at num_neg=5.
    Bias gradients ride the SAME aggregation as extra value columns."""
    sm = cfg.scatter_mode
    B = u.shape[0]
    uv_u = params["uv"][u]
    iv_i, iv_j = params["iv"][i], params["iv"][j]
    ib_i, ib_j = params["ib"][i], params["ib"][j]
    d_uv_rows, pos_vals, neg_vals, with_bias = _pair_contribs(
        uv_u, iv_i, iv_j, ib_i, ib_j, w, cfg, loss,
        rank_weight=rank_weight, update_bias=update_bias,
    )
    D = params["uv"].shape[1]
    I = params["iv"].shape[0]
    # ONE concatenated aggregation for the item table: chaining two
    # scatter_add_rows through the same accumulator de-partitions the whole
    # program under GSPMD (measured: zero collectives — the sharded trainer
    # silently fell back to replicated compute); a single call over the
    # concatenated pos+neg rows partitions cleanly (one psum).
    C = pos_vals.shape[-1]
    acc_idx = jnp.concatenate([i, j.reshape(-1)])
    acc_vals = jnp.concatenate([pos_vals, neg_vals.reshape(-1, C)])
    acc = scatter_add_rows(jnp.zeros((I, C), pos_vals.dtype), acc_idx,
                           acc_vals, mode=sm)
    grads = {
        "uv": scatter_add_rows(
            jnp.zeros_like(params["uv"]), u, d_uv_rows, mode=sm
        ),
        "iv": acc[:, :D],
    }
    if with_bias:
        grads["ib"] = acc[:, D]
    return grads


def _pairwise_apply(params, u, i, j, w, cfg, loss, rank_weight=None,
                    update_bias=True):
    """One pairwise minibatch update: full-table accumulate-then-apply
    AdaGrad, or O(B·(1+nn)) touched-rows delta AdaGrad for huge catalogs
    (see MFConfig.row_update)."""
    if not _use_row_update(cfg, params["iv"].shape[0]):
        return _adagrad_apply(
            params,
            _pairwise_grads(params, u, i, j, w, cfg, loss,
                            rank_weight=rank_weight,
                            update_bias=update_bias),
            cfg,
        )
    d_uv_rows, pos_vals, neg_vals, with_bias = _pair_contribs(
        params["uv"][u], params["iv"][i], params["iv"][j],
        params["ib"][i], params["ib"][j], w, cfg, loss,
        rank_weight=rank_weight, update_bias=update_bias,
    )
    D = params["uv"].shape[1]
    C = pos_vals.shape[-1]
    lr, beta, ada = cfg.learn_rate, cfg.beta, cfg.using_adagrad
    acc_idx = jnp.concatenate([i, j.reshape(-1)])
    acc_vals = jnp.concatenate([pos_vals, neg_vals.reshape(-1, C)])
    u_live = jnp.any(w > 0, axis=1)
    live = jnp.concatenate([u_live, (w > 0).reshape(-1)])
    out = dict(params)
    out["iv"], out["iv_ag"] = row_adagrad_delta(
        params["iv"], params["iv_ag"], acc_idx, acc_vals[:, :D],
        live[:, None], lr, beta, ada)
    if with_bias:
        out["ib"], out["ib_ag"] = row_adagrad_delta(
            params["ib"], params["ib_ag"], acc_idx, acc_vals[:, D],
            live, lr, beta, ada)
    out["uv"], out["uv_ag"] = row_adagrad_delta(
        params["uv"], params["uv_ag"], u, d_uv_rows, u_live[:, None],
        lr, beta, ada)
    return out


class BPR(_MFBase):
    """Bayesian personalized ranking (ref bpr.hpp). Default loss LOG
    (ref BPRConfig bpr.hpp:17); num_neg pairs per positive.

    Two step implementations:
    - sparse path (default): shuffled instance minibatches, num_neg exact
      complement draws per positive, factored one-hot scatter aggregation.
      Matches the reference's per-pair cadence closely but is bound by
      per-instance row gathers.
    - dense slab (``dense_mode=True``): per-USER batches. One
      (B,D)x(D,I) matmul scores the whole catalog, M=num_shared_neg
      negatives are drawn per user and SHARED by all of the user's
      positives at weight num_neg/M_live — an unbiased restructuring of
      the reference's num_neg independent draws per positive (both sample
      uniform over the user's unrated items; only the pairing layout
      changes). All pos-side gradient aggregation becomes dense matmuls
      (posW.T @ uv / posW @ iv); only the B·M neg rows scatter.
    """

    name = "BPR"
    dense_capable = True
    dense_auto = False  # slab cadence is a measured trade — opt-in

    def __init__(self, config: Optional[MFConfig] = None, **kw):
        if config is None and "loss" not in kw:
            kw["loss"] = "LOG"
        super().__init__(config, **kw)

    @staticmethod
    def _step(params, u, i, r, w, rated, lengths, key, *, cfg, loss):
        I = params["iv"].shape[0]
        nn = max(cfg.num_neg, 1)
        neg = sampling.sample_unrated(key, rated, lengths, I, nn)  # (B,nn)
        # sentinel id I = empty complement -> zero-weight those pairs
        pair_w = w[:, None] * (neg < I).astype(w.dtype)
        return _pairwise_apply(
            params, u, i, jnp.clip(neg, 0, I - 1), pair_w, cfg, loss
        )

    @staticmethod
    def _dense_step(params, R, ratings, uids, weight, key, *, cfg, loss):
        """Per-user dense slab with shared negatives (docstring above).

        Pair math follows _pair_contribs / ref bpr.hpp:72-106 exactly —
        g = loss'(s(u,i) − s(u,j), 1), each pair adds its own 2λ·param
        term, ub never updates (it cancels in the pair score) — only the
        negative-sampling layout is restructured (per-user shared draws
        instead of per-positive independent draws; both uniform over the
        user's unrated items)."""
        dt = params["uv"].dtype
        I = params["iv"].shape[0]
        B = uids.shape[0]
        M = max(cfg.num_shared_neg, 1)
        nn = max(cfg.num_neg, 1)
        lam2 = 2.0 * cfg.lambda_
        w_user = weight.astype(dt)
        rows01 = R[uids].astype(dt)  # (B, I) 0/1 positives
        rows = rows01 * w_user[:, None]
        uv_u = params["uv"][uids]  # (B, D)
        S = uv_u @ params["iv"].T + params["ib"][None, :]  # (B, I)
        # M shared draws per user, uniform over the catalog; draws that
        # land on a rated item are zero-weighted (uniform over unrated
        # conditional on being live — the rated fraction is typically a
        # few percent, so M_live ≈ M). The all-M-draws-rated event used to
        # drop the user's whole epoch contribution (ADVICE r3, systematic
        # under-training of very dense users at small num_shared_neg); a
        # RESCUE draw now covers it: one EXACT complement draw per user
        # (rank-select of the u-th zero of the dense row via a fused
        # (B, I) compare+reduce), substituted into slot 0 only when every
        # catalog draw was rated.
        k_draw, k_rescue = jax.random.split(key)
        j = jax.random.randint(k_draw, (B, M), 0, I)
        live = (
            1.0 - jnp.take_along_axis(rows01, j, axis=1)
        ) * w_user[:, None]  # (B, M) 1 iff draw is unrated and row is real
        m_live0 = jnp.sum(live, axis=1)  # (B,)
        L_u = jnp.sum(rows, axis=1)  # (B,) w-weighted positive count
        # L_u == n_rated on real (w=1) rows; w=0 rows are excluded anyway
        need = (m_live0 <= 0) & (L_u < jnp.float32(I)) & (w_user > 0)  # (B,)

        def _with_rescue(j, live):
            n_rated = jnp.sum((rows01 > 0).astype(jnp.int32), axis=1)
            free = jnp.maximum(I - n_rated, 1)  # complement size per row
            u_rank = jax.random.randint(k_rescue, (B, 1), 0,
                                        free[:, None], dtype=jnp.int32)
            # (u+1)-th zero of the row = #{i : zcum[i] <= u} (zcum monotone)
            zcum = jnp.cumsum((rows01 <= 0).astype(jnp.int32), axis=1)
            j_rescue = jnp.clip(
                jnp.sum((zcum <= u_rank).astype(jnp.int32), axis=1), 0, I - 1
            )  # (B,) exact uniform over the user's unrated items
            slot0 = jnp.arange(M, dtype=jnp.int32)[None, :] == 0
            hit = need[:, None] & slot0
            return (jnp.where(hit, j_rescue[:, None], j),
                    jnp.where(hit, 1.0, live))

        # the rescue branch costs ~3 extra (B, I) passes; it only RUNS on
        # the rare step where some row drew all-rated (lax.cond executes
        # one branch at runtime)
        j, live = jax.lax.cond(
            jnp.any(need), _with_rescue, lambda j, live: (j, live), j, live
        )
        m_live = jnp.sum(live, axis=1)  # (B,) >= 1 iff complement non-empty
        # per-pair weight a_u = num_neg / M_live (expected per-positive
        # update mass == the reference's num_neg draws)
        a = jnp.where(m_live > 0, nn / jnp.maximum(m_live, 1.0), 0.0)  # (B,)
        t = jnp.take_along_axis(S, j, axis=1)  # (B, M) negative scores
        # fused (B, I, M) reductions — XLA fuses broadcast+grad+reduce, the
        # cube never materializes in HBM
        g = loss.gradient(S[:, :, None] - t[:, None, :], 1.0)  # (B, I, M)
        pos_w = rows * a[:, None] * jnp.sum(
            g * live[:, None, :], axis=2
        )  # (B, I): per-positive summed pair grads
        neg_w = live * a[:, None] * jnp.sum(
            g * rows[:, :, None], axis=1
        )  # (B, M): per-draw summed pair grads
        # touch counts for the per-pair 2λ terms; a row with no live
        # negative (empty complement) forms no pairs, so its positives get
        # no per-pair λ term either (ref: each 2λ term rides an actual pair
        # update, bpr.hpp:84-100)
        has_pair = (m_live > 0).astype(dt)  # (B,)
        pos_touch = rows * (w_user * nn * has_pair)[:, None]  # (B, I)
        neg_touch = jnp.where(m_live > 0, a * L_u, 0.0)[:, None] * live
        col_touch = jnp.sum(pos_touch, axis=0)  # (I,)
        # --- item table: dense pos-side matmul + B·M neg-row scatter ----
        iv_j = params["iv"][j]  # (B, M, D)
        ib_j = params["ib"][j]  # (B, M)
        d_iv = pos_w.T @ uv_u + lam2 * col_touch[:, None] * params["iv"]
        neg_vals = (-neg_w)[:, :, None] * uv_u[:, None, :] + (
            lam2 * neg_touch[:, :, None] * iv_j
        )
        d_ib = jnp.sum(pos_w, axis=0) + lam2 * col_touch * params["ib"]
        neg_bias = -neg_w + lam2 * neg_touch * ib_j
        sm = cfg.scatter_mode
        C = neg_vals.shape[-1]
        d_iv = d_iv + scatter_add_rows(
            jnp.zeros_like(d_iv), j.reshape(-1), neg_vals.reshape(-1, C),
            mode=sm,
        )
        d_ib = d_ib + scatter_add_rows(
            jnp.zeros_like(d_ib), j.reshape(-1), neg_bias.reshape(-1),
            mode=sm,
        )
        grads = {"iv": d_iv}
        if cfg.using_bias_term:
            grads["ib"] = d_ib
        # --- user rows: dense matmuls both sides (pre-update iv, like the
        # reference's compute-all-grads-then-update per pair) -------------
        d_uv = (
            pos_w @ params["iv"]
            - jnp.einsum("bm,bmd->bd", neg_w, iv_j)
            + lam2 * (w_user * nn * has_pair)[:, None] * L_u[:, None] * uv_u
        )
        params = _adagrad_apply(params, grads, cfg)
        return _dense_row_apply(params, {"uv": d_uv}, uids, w_user, cfg)


class WARP(_MFBase):
    """Weighted approximate-rank pairwise (ref warp.hpp). Default HINGE loss,
    beta=0, lambda=0.1 (WARPConfig warp.hpp:12-23). For each positive and
    each of num_neg updates, draw candidate negatives until the FIRST
    violator (s(u,j) > s(u,i) − 1), capped at ``num_tries``; the update is
    weighted by the harmonic rank weight l[items_left / cnt]
    (ref warp.hpp:63-88).

    Two equivalent step implementations:
    - dense path (auto when the (U, I) rated mask fits HBM): computes the
      full score row once, then samples (cnt, j) from the CLOSED FORM of
      the rejection process — cnt ~ Geometric(p = |violators| / |unrated|)
      truncated at num_tries, j uniform over violators via rank-select.
      Distribution-identical to scanning i.i.d. complement draws, with no
      num_tries factor in the cost.
    - scan path (huge catalogs / no mask): materializes num_tries
      candidates per slot and takes the first violator.
    """

    name = "WARP"
    dense_capable = True
    dense_auto = False  # slab cadence is a measured trade — opt-in

    def __init__(self, config: Optional[MFConfig] = None, **kw):
        if config is None:
            kw.setdefault("loss", "HINGE")
            kw.setdefault("beta", 0.0)
            kw.setdefault("lambda_", 0.1)
        super().__init__(config, **kw)

    @staticmethod
    def _dense_step(params, R, ratings, uids, weight, key, *, cfg, loss):
        """Per-user dense slab with pooled violators (dense_mode=True).

        Restructures the reference's per-(positive, slot) rejection loop
        (warp.hpp:63-117) the way BPR._dense_step restructures BPR:
        - ONE (B,D)x(D,I) matmul scores every candidate positive;
        - a shared pool of P=warp_pool uniform ids stands in for the
          complement draws (CDAE neg_pool construction);
        - per positive, the try count cnt ~ Geometric(p̂) with p̂ the
          pool violator fraction (closed form of the rejection process),
          sampled nn times -> rank weights l[items_left/cnt];
        - the sampled uniform violator is RAO-BLACKWELLIZED: instead of
          picking one violator per slot, every pool violator receives the
          slot's update at weight 1/nviol — expectation-identical (the
          selection is uniform and the rank weight is independent of
          which violator is drawn), strictly lower variance, and the
          selection argmax disappears into the same fused (B, I, P)
          reduction that counts violators.
        All pos-side aggregation is dense matmuls; only the P pool rows
        scatter. ub/ib never update (ref warp.hpp:90-117)."""
        dt = params["uv"].dtype
        I = params["iv"].shape[0]
        B = uids.shape[0]
        nn = max(cfg.num_neg, 1)
        T = max(cfg.num_tries, 1)
        # default pool 1024: vs 256 it fixed the systematic quality
        # deficit of the dense cell (3-seed oracle deltas mean −0.032 at
        # pool 256 vs −0.010 at 1024 with the 3x cadence lr;
        # scripts/parity_zoo.py WARP_DENSE)
        P = int(cfg.warp_pool or 1024)
        lam2 = 2.0 * cfg.lambda_
        w_user = weight.astype(dt)
        rows01 = R[uids].astype(dt)  # (B, I) 0/1
        rows = rows01 * w_user[:, None]
        uv_u = params["uv"][uids]  # (B, D)
        S = uv_u @ params["iv"].T + params["ib"][None, :]  # (B, I)
        k_pool, k_cnt = jax.random.split(key)
        pool = jax.random.randint(k_pool, (P,), 0, I, dtype=jnp.int32)
        S_p = jnp.take(S, pool, axis=1)  # (B, P)
        unrated_p = (
            (jnp.take(rows01, pool, axis=1) == 0).astype(dt)
            * w_user[:, None]
        )  # (B, P)
        pool_live = jnp.sum(unrated_p, axis=1)  # (B,)
        # fused (B, I, P) violation cube: pool score beats the candidate
        # positive's margin threshold (never materialized in HBM)
        viol = (
            (S_p[:, None, :] > (S[:, :, None] - 1.0))
            & (unrated_p[:, None, :] > 0)
        )
        nv = jnp.sum(viol.astype(jnp.float32), axis=2)  # (B, I)
        p_hat = nv / jnp.maximum(pool_live, 1.0)[:, None]
        # rank weights in CLOSED FORM: the reference draws cnt ~ tries to
        # first violator (≤ T) and weights by l[items_left/cnt]
        # (warp.hpp:70-88). cnt is independent of WHICH violator is drawn,
        # so it Rao-Blackwellizes like the selection: replace the sampled
        # cnt by its expectation under the truncated Geometric(p̂) —
        #   rwsum = nn·Σ_{c=1..T} p̂(1−p̂)^{c−1} · l[items_left//c]
        #   ftot  = nn·(1−(1−p̂)^T)          (pairs that find a violator)
        # — no per-(u,i,slot) RNG and no (B,I,nn) harmonic-table gather.
        L_u = jnp.sum(rows, axis=1)
        items_left = jnp.maximum(I - L_u.astype(jnp.int32), 1)  # (B,)
        l_tab = _warp_harmonic(I)
        c_grid = jnp.arange(1, T + 1, dtype=jnp.int32)  # (T,)
        lw = l_tab[jnp.clip(items_left[:, None] // c_grid[None, :],
                            0, I - 1)]  # (B, T)
        log1mp = jnp.log1p(-jnp.clip(p_hat, 0.0, 1.0 - 1e-7))  # (B, I)
        pow_c = jnp.exp(
            log1mp[:, :, None] * (c_grid - 1).astype(jnp.float32)
        )  # (B, I, T) = (1−p̂)^{c−1}, fused
        rwsum = nn * p_hat * jnp.einsum("bit,bt->bi", pow_c, lw)
        ftot = (nn * (1.0 - jnp.exp(
            jnp.float32(T) * log1mp
        ))).astype(dt)  # (B, I)
        coef = rows * rwsum / jnp.maximum(nv, 1.0)  # (B, I)
        # pair grads: g = loss'(s_i − s_p, 1) on violators (HINGE: g = −1)
        g = loss.gradient(S[:, :, None] - S_p[:, None, :], 1.0) * viol
        pos_w = coef * jnp.sum(g, axis=2)  # (B, I) Σ_p over violators
        n_w = jnp.sum(coef[:, :, None] * g, axis=1)  # (B, P) Σ_i
        n_touch = jnp.sum(
            (rows * ftot / jnp.maximum(nv, 1.0))[:, :, None] * viol, axis=1
        )  # (B, P) per-pool-slot λ-touch mass
        pos_touch = rows * ftot  # (B, I)
        col_touch = jnp.sum(pos_touch, axis=0)  # (I,)
        iv_pool = params["iv"][pool]  # (P, D)
        d_iv = pos_w.T @ uv_u + lam2 * col_touch[:, None] * params["iv"]
        pool_vals = (
            -(n_w.T @ uv_u)
            + lam2 * jnp.sum(n_touch, axis=0)[:, None] * iv_pool
        )  # (P, D)
        d_iv = d_iv + scatter_add_rows(
            jnp.zeros_like(d_iv), pool, pool_vals, mode=cfg.scatter_mode
        )
        pairtot = jnp.sum(pos_touch, axis=1)  # (B,)
        d_uv = (
            pos_w @ params["iv"]
            - n_w @ iv_pool
            + lam2 * pairtot[:, None] * uv_u
        )
        params = _adagrad_apply(params, {"iv": d_iv}, cfg)
        return _dense_row_apply(params, {"uv": d_uv}, uids, w_user, cfg)

    def _epoch_extras(self, state: ModelState) -> tuple:
        U, I = state.num_users, state.num_items
        use_dense = self.cfg.dense_mode
        if use_dense is None:
            use_dense = U * I <= 1_500_000_000
        if not use_dense:
            return ()
        if "rated_mask" not in state.aux:
            users, items, _ = state.aux["coo"]
            state.aux["rated_mask"] = (
                jnp.zeros((U, I), jnp.int8)
                .at[jnp.asarray(users), jnp.asarray(items)]
                .set(1)
            )
        return (state.aux["rated_mask"],)

    @staticmethod
    def _step(params, u, i, r, w, rated, lengths, key, *extras, cfg, loss):
        if extras:
            if cfg.warp_pool:
                return WARP._pool_path(
                    params, u, i, w, lengths, key, extras[0],
                    cfg=cfg, loss=loss,
                )
            return WARP._dense_path(
                params, u, i, w, lengths, key, extras[0], cfg=cfg, loss=loss
            )
        if cfg.warp_pool:
            # no dense (U, I) mask (huge catalog / dense_mode=False): the
            # pool path still runs — pool membership comes from the padded
            # CSR rows (bitwise the same unrated test, so the trajectory
            # matches the mask-based pool path at equal keys)
            return WARP._pool_path(
                params, u, i, w, lengths, key, None, rated=rated,
                cfg=cfg, loss=loss,
            )
        return WARP._scan_path(
            params, u, i, w, rated, lengths, key, cfg=cfg, loss=loss
        )

    @staticmethod
    def _pool_path(params, u, i, w, lengths, key, mask_rows, *, cfg, loss,
                   rated=None):
        """Pooled-candidate rejection process (MFConfig.warp_pool).

        The reference draws complement candidates one at a time until the
        first violator (warp.hpp:63-88). Here each step draws ONE shared
        pool of P uniform item ids; the per-instance try stream is modeled
        against pool violators: cnt ~ Geometric(p̂) with p̂ the violator
        fraction among the instance's unrated pool entries, and j uniform
        over the instance's pool violators (argmax-of-iid-noise). Exact in
        the P→I limit; at P≪I it adds pool sampling variance (metric
        parity gated like CDAE's neg_pool).

        Pool membership comes from ``mask_rows`` (the row-gathered dense
        rated mask) when available, else from the padded CSR ``rated``
        rows (huge-catalog regime) — identical truth tables."""
        I = params["iv"].shape[0]
        B = u.shape[0]
        nn = max(cfg.num_neg, 1)
        T = max(cfg.num_tries, 1)
        P = int(cfg.warp_pool)
        uv_u = params["uv"][u]  # (B, D)
        yui = params["ib"][i] + jnp.sum(uv_u * params["iv"][i], -1)
        k_pool, k_cnt, k_sel = jax.random.split(key, 3)
        pool = jax.random.randint(k_pool, (P,), 0, I, dtype=jnp.int32)
        s_pool = (
            uv_u @ params["iv"][pool].T + params["ib"][pool][None, :]
        )  # (B, P)
        if mask_rows is not None:
            unrated = jnp.take(mask_rows, pool, axis=1) == 0  # (B, P)
        else:
            # huge-catalog form: membership from the padded CSR rows —
            # identical truth table to the dense-mask gather
            unrated = ~sampling.is_rated(rated, lengths, pool)  # (B, P)
        viol = (s_pool > (yui[:, None] - 1.0)) & unrated
        nv = jnp.sum(viol.astype(jnp.int32), axis=1)  # (B,)
        pool_live = jnp.sum(unrated.astype(jnp.int32), axis=1)
        p = nv.astype(jnp.float32) / jnp.maximum(
            pool_live.astype(jnp.float32), 1.0
        )
        u1 = jax.random.uniform(k_cnt, (B, nn), minval=1e-7, maxval=1.0)
        noise = jax.random.uniform(k_sel, (B, nn, P))
        log1mp = jnp.log1p(-jnp.clip(p, 0.0, 1.0 - 1e-7))[:, None]
        cnt = 1 + jnp.floor(jnp.log(u1) / jnp.minimum(log1mp, -1e-12))
        cnt = cnt.astype(jnp.int32)
        found = (nv[:, None] > 0) & (cnt <= T)
        cnt = jnp.clip(cnt, 1, T)
        # per-slot uniform pool violator via argmax of iid noise
        masked = jnp.where(viol[:, None, :], noise, -1.0)  # (B, nn, P)
        sel = jnp.argmax(masked, axis=2).astype(jnp.int32)  # (B, nn)
        j = pool[sel]  # (B, nn)
        items_left = jnp.maximum(I - lengths, 1)
        l_tab = _warp_harmonic(I)
        rw = l_tab[jnp.clip(items_left[:, None] // cnt, 0, I - 1)]
        pair_w = w[:, None] * found
        return _pairwise_apply(
            params, u, i, j, pair_w, cfg, loss, rank_weight=rw,
            update_bias=False,
        )

    @staticmethod
    def _dense_path(params, u, i, w, lengths, key, mask_rows, *, cfg, loss):
        I = params["iv"].shape[0]
        B = u.shape[0]
        nn = max(cfg.num_neg, 1)
        T = max(cfg.num_tries, 1)
        uv_u = params["uv"][u]  # (B, D)
        k1, k2 = jax.random.split(key)
        viol, nviol = _warp_violators(uv_u, params["iv"], params["ib"], i,
                                      mask_rows)
        free = jnp.maximum(I - lengths, 1)
        p = nviol.astype(jnp.float32) / free.astype(jnp.float32)
        # cnt ~ Geometric(p) truncated at T: first-success index of i.i.d.
        # complement draws (exactly the rejection loop's try counter)
        u1 = jax.random.uniform(k1, (B, nn), minval=1e-7, maxval=1.0)
        log1mp = jnp.log1p(-jnp.clip(p, 0.0, 1.0 - 1e-7))[:, None]
        cnt = 1 + jnp.floor(jnp.log(u1) / jnp.minimum(log1mp, -1e-12))
        cnt = cnt.astype(jnp.int32)
        found = (nviol[:, None] > 0) & (cnt <= T)
        cnt = jnp.clip(cnt, 1, T)
        # j uniform over violators: v-th violator via cumulative-count
        # rank-select
        v = jax.random.randint(k2, (B, nn), 0,
                               jnp.maximum(nviol, 1)[:, None])
        cumviol = jnp.cumsum(viol.astype(jnp.int32), axis=1)  # (B, I)
        # index of the (v+1)-th violator = first idx with cumviol > v.
        # A batched bisection over the monotone cumviol rows costs
        # ceil(log2 I)+1 (B, nn) gathers — the one-shot compare+reduce
        # alternative materializes (B, I, nn)
        j = _rank_select_first_gt(cumviol, v)
        j = jnp.clip(j, 0, I - 1)
        items_left = jnp.maximum(I - lengths, 1)
        l_tab = _warp_harmonic(I)
        rw = l_tab[jnp.clip(items_left[:, None] // cnt, 0, I - 1)]
        pair_w = w[:, None] * found
        return _pairwise_apply(
            params, u, i, j, pair_w, cfg, loss, rank_weight=rw,
            update_bias=False,  # ref warp.hpp:90-117 bias updates commented out
        )

    @staticmethod
    def _scan_path(params, u, i, w, rated, lengths, key, *, cfg, loss):
        I = params["iv"].shape[0]
        B = u.shape[0]
        nn = max(cfg.num_neg, 1)
        T = max(cfg.num_tries, 1)
        # candidates for all (instance, neg-slot) pairs: (B, nn*T)
        cand_raw = sampling.sample_unrated(key, rated, lengths, I, nn * T)
        cand_raw = cand_raw.reshape(B, nn, T)
        cand_valid = cand_raw < I  # sentinel = empty complement
        cand = jnp.clip(cand_raw, 0, I - 1)
        uv_u = params["uv"][u]  # (B,D)
        yui = params["ib"][i] + jnp.sum(uv_u * params["iv"][i], -1)  # (B,)
        # note: reference WARP compares full predictions including ub which
        # cancels in yui - yuj; ib does not cancel — include it
        yuj = params["ib"][cand] + jnp.einsum(
            "bd,bntd->bnt", uv_u, params["iv"][cand]
        )  # (B,nn,T)
        violation = (yuj > (yui[:, None, None] - 1.0)) & cand_valid
        found = jnp.any(violation, axis=-1)  # (B,nn)
        first = jnp.argmax(violation, axis=-1)  # (B,nn) index of first True
        cnt = first + 1  # tries used (ref warp.hpp:70-79)
        j = jnp.take_along_axis(cand, first[..., None], axis=-1)[..., 0]
        items_left = jnp.maximum(I - lengths, 1)  # (B,)
        # rank-weight table lookup l_[items_left / cnt] (ref warp.hpp:84)
        l_tab = _warp_harmonic(I)
        rw = l_tab[jnp.clip(items_left[:, None] // cnt, 0, I - 1)]  # (B,nn)
        pair_w = w[:, None] * found  # (B, nn)
        return _pairwise_apply(
            params, u, i, j, pair_w, cfg, loss, rank_weight=rw,
            update_bias=False,  # ref warp.hpp:90-117 bias updates commented out
        )


def _warp_violators(uv_u, iv, ib, i, mask_rows):
    """Dense WARP violators (ref warp.hpp:63-79): the (B, I) mask of
    unrated items j with s(u,j) > s(u,i) - 1, and its per-row count."""
    scores = uv_u @ iv.T + ib[None, :]  # (B, I)
    yui = jnp.take_along_axis(scores, i[:, None], axis=1)[:, 0]
    viol = (scores > (yui[:, None] - 1.0)) & (mask_rows == 0)
    return viol, jnp.sum(viol.astype(jnp.int32), axis=1)


def _rank_select_first_gt(cum: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Per-row first index where the nondecreasing ``cum`` row exceeds v.

    cum: (B, I) int32 cumulative counts; v: (B, K) int32 targets.
    Batched bisection: ceil(log2 I)+1 rounds of (B, K) take_along_axis
    gathers — no (B, I, K) broadcast."""
    I = cum.shape[1]
    bits = int(np.ceil(np.log2(max(I, 2)))) + 1
    lo = jnp.zeros_like(v)
    hi = jnp.full_like(v, I)

    def body(_, lohi):
        lo, hi = lohi
        mid = jnp.clip((lo + hi) // 2, 0, I - 1)
        c = jnp.take_along_axis(cum, mid, axis=1)  # (B, K)
        gt = c > v
        return jnp.where(gt, lo, mid + 1), jnp.where(gt, mid, hi)

    lo, hi = jax.lax.fori_loop(0, bits, body, (lo, hi))
    return lo


@functools.lru_cache(maxsize=8)
def _warp_harmonic_np(num_items: int):
    l = 1.0 + np.concatenate(
        [[0.0], np.cumsum(1.0 / np.arange(2.0, num_items + 1.0))]
    )[:num_items]
    return l.astype(np.float32)


def _warp_harmonic(num_items: int) -> jnp.ndarray:
    return jnp.asarray(_warp_harmonic_np(num_items))
