"""ShardedCDAE — the flagship model trained over a ('data','model') mesh,
drop-in compatible with Solver/Evaluation (SURVEY §7 stage 6, end-to-end).

Wraps the single-chip CDAE: identical math (the sharded step is bitwise-equal
to the single-device step, see tests/test_parallel.py), with parameters laid
out per parallel/mesh.cdae_param_specs and every minibatch placed sharded
over the 'data' axis. Scoring emits a (batch, items) matrix sharded over
BOTH axes; top-k for evaluation merges per-shard candidates
(parallel/topk.py) or lets XLA gather for the generic evaluator path.

Usage:
    mesh = make_mesh(n_model=2)          # after distributed.initialize()
    model = ShardedCDAE(CDAEConfig(...), mesh=mesh)
    Solver(model, max_iteration=50).train(train, test, ["TOPN"])
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cdae_jax.data.dataset import Interactions
from cdae_jax.models.base import RecsysModel
from cdae_jax.models.cdae import CDAE, CDAEConfig, CDAEState
from cdae_jax.parallel.mesh import make_mesh
from cdae_jax.parallel.sharded import (
    make_sharded_scores,
    make_sharded_train_step,
    shard_cdae_state,
)


class ShardedCDAE(RecsysModel):
    name = "ShardedCDAE"

    def __init__(self, config: Optional[CDAEConfig] = None,
                 mesh: Optional[Mesh] = None, **kw):
        cfg = config if config is not None else CDAEConfig(**kw)
        # dense_mode (explicitly True) runs the item-sharded dense slabs;
        # default/None keeps the sparse formulation.
        cfg = dataclasses.replace(cfg, dense_mode=bool(cfg.dense_mode))
        self.inner = CDAE(cfg)
        self.cfg = self.inner.cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self._step = None
        self._dense_step = None
        self._scores = None

    # ------------------------------------------------------------- reset ----
    def reset(self, data: Interactions, seed: int = 0) -> CDAEState:
        from cdae_jax.parallel.sharded import make_sharded_dense_step

        state = self.inner.reset(data, seed)
        state.params = shard_cdae_state(self.mesh, state.params)
        self._step = make_sharded_train_step(self.inner, self.mesh,
                                             state.params)
        self._scores = make_sharded_scores(self.inner, self.mesh,
                                           state.params)
        self._dense_step = None  # cleared: dispatch must follow THIS state
        if "dense_R" in state.aux:
            state.aux["dense_R"] = jax.device_put(
                state.aux["dense_R"],
                NamedSharding(self.mesh, P("data", "model")),
            )
            self._dense_step = make_sharded_dense_step(
                self.inner, self.mesh, state.params
            )
        return state

    def _sharded_dense_batches(self, state: CDAEState):
        """Dense uid/weight rows pre-placed P('data') ONCE (not per step)."""
        if "sharded_dense_batches" not in state.aux:
            data_sh = NamedSharding(self.mesh, P(None, "data"))
            uid_mat, w_mat = self.inner._dense_batches(state)
            state.aux["sharded_dense_batches"] = (
                jax.device_put(uid_mat, data_sh),
                jax.device_put(w_mat, data_sh),
            )
        return state.aux["sharded_dense_batches"]

    def _device_batches(self, state: CDAEState):
        """Batches placed sharded over the 'data' mesh axis (cached)."""
        if "sharded_batches" not in state.aux:
            data_sh = NamedSharding(self.mesh, P("data"))
            row_sh = NamedSharding(self.mesh, P("data", None))
            out = []
            for b in self.inner._host_batches(state):
                out.append((
                    jax.device_put(b.uids, data_sh),
                    jax.device_put(b.items, row_sh),
                    jax.device_put(b.mask, row_sh),
                    jax.device_put(b.lengths, data_sh),
                    jax.device_put(b.weight, data_sh),
                ))
            state.aux["sharded_batches"] = out
        return state.aux["sharded_batches"]

    # ------------------------------------------------------------- train ----
    def train_one_iteration(self, state: CDAEState, rng_key) -> CDAEState:
        params = state.params
        if self._dense_step is not None and "dense_R" in state.aux:
            R = state.aux["dense_R"]
            uid_mat, w_mat = self._sharded_dense_batches(state)
            for j in range(uid_mat.shape[0]):
                uids_j, w_j = uid_mat[j], w_mat[j]
                for _ in range(self.cfg.num_corruptions):
                    rng_key, sub = jax.random.split(rng_key)
                    params = self._dense_step(params, R, uids_j, w_j, sub)
            state.params = params
            state.step += 1
            return state
        for uids, items, mask, lengths, weight in self._device_batches(state):
            for _ in range(self.cfg.num_corruptions):
                rng_key, sub = jax.random.split(rng_key)
                params = self._step(params, uids, items, mask, lengths,
                                    weight, sub)
        state.params = params
        state.step += 1
        return state

    # -------------------------------------------------------- loss / eval ---
    def data_loss(self, state: CDAEState, sample_size: int = 0) -> float:
        return self.inner.data_loss(state, sample_size)

    def penalty_loss(self, state: CDAEState) -> float:
        return self.inner.penalty_loss(state)

    def batch_scores(self, state: CDAEState, uids, rated_items, rated_mask):
        data_sh = NamedSharding(self.mesh, P("data"))
        row_sh = NamedSharding(self.mesh, P("data", None))
        return self._scores(
            state.params,
            jax.device_put(np.asarray(uids), data_sh),
            jax.device_put(np.asarray(rated_items), row_sh),
            jax.device_put(np.asarray(rated_mask), row_sh),
        )

    def batch_topk(self, state: CDAEState, uids, rated_items, rated_mask,
                   k: int = 10):
        """Evaluation fast path on the mesh: per-shard top-k over the
        ('data','model')-sharded score blocks merged over 'model'
        (parallel/topk.distributed_topk_unrated) — the full (B, I) score
        matrix is never gathered onto one chip, the CP/SP analog of the
        reference's full-catalog heap scan (cdae.hpp:176-186) at catalog
        sizes one chip's HBM cannot hold."""
        if state.num_items % self.mesh.shape["model"] != 0:
            return None  # uneven item shards: evaluator's scores path
        from cdae_jax.parallel.topk import distributed_topk_unrated

        scores = self.batch_scores(state, uids, rated_items, rated_mask)
        ids, _ = distributed_topk_unrated(
            self.mesh, scores, jnp.asarray(np.asarray(rated_items)), k
        )
        return ids

    def predict(self, state: CDAEState, users, items):
        return self.inner.predict(state, users, items)

    def user_representations(self, state: CDAEState):
        return self.inner.user_representations(state)


class ShardedIMF(RecsysModel):
    """IMF trained over the ('data','model') mesh in dense full-catalog
    mode — the MF-family counterpart of ShardedCDAE (ROADMAP r1 top Scale
    item; ref algorithm imf.hpp:71-115, reformulated as sharded (B, I)
    slabs whose matmuls partition over both axes, see
    parallel/sharded.make_sharded_mf_dense_step).

    Drop-in for Solver/Evaluation. Dense mode is mandatory: the sharded
    step IS the dense-slab step (single-chip sparse IMF remains the
    fallback for catalogs whose (U, I) slab cannot exist).
    """

    name = "ShardedIMF"

    def __init__(self, config=None, mesh: Optional[Mesh] = None, **kw):
        from cdae_jax.models.mf import IMF, MFConfig

        cfg = config if config is not None else MFConfig(**kw)
        cfg = dataclasses.replace(cfg, dense_mode=True)
        self.inner = IMF(cfg)
        self.cfg = self.inner.cfg
        self.loss = self.inner.loss
        self.mesh = mesh if mesh is not None else make_mesh()
        self._dense_step = None
        self._scores = None

    def reset(self, data: Interactions, seed: int = 0):
        from cdae_jax.models.mf import _mf_batch_scores
        from cdae_jax.parallel.mesh import mf_param_specs, shard_params
        from cdae_jax.parallel.sharded import make_sharded_mf_dense_step

        state = self.inner.reset(data, seed)
        if "dense_R" not in state.aux:
            raise ValueError(
                "ShardedIMF requires dense mode (U*I slab); use single-chip "
                "IMF for catalogs beyond the dense budget"
            )
        specs = mf_param_specs(state.params)
        state.params = shard_params(self.mesh, state.params, specs)
        state.aux["dense_R"] = jax.device_put(
            state.aux["dense_R"],
            NamedSharding(self.mesh, P("data", "model")),
        )
        self._dense_step = make_sharded_mf_dense_step(
            self.inner, self.mesh, state.params
        )
        self._scores = jax.jit(
            _mf_batch_scores,
            in_shardings=(
                {k: NamedSharding(self.mesh, s) for k, s in specs.items()},
                NamedSharding(self.mesh, P("data")),
            ),
            out_shardings=NamedSharding(self.mesh, P("data", "model")),
        )
        return state

    def _sharded_dense_batches(self, state):
        if "sharded_dense_batches" not in state.aux:
            sh = NamedSharding(self.mesh, P(None, "data"))
            uid_mat, w_mat = self.inner._dense_user_batches(state)
            state.aux["sharded_dense_batches"] = (
                jax.device_put(uid_mat, sh), jax.device_put(w_mat, sh),
            )
        return state.aux["sharded_dense_batches"]

    def train_one_iteration(self, state, rng_key):
        R = state.aux["dense_R"]
        ratings = state.aux.get("dense_ratings", R)
        uid_mat, w_mat = self._sharded_dense_batches(state)
        params = state.params
        # pre-split per-slab keys: the SAME stream layout as the single-chip
        # fused dense-epoch scan (models/mf._MFBase.train_one_iteration), so
        # the trajectory-match test stays bitwise
        subs = jax.random.split(rng_key, uid_mat.shape[0])
        for j in range(uid_mat.shape[0]):
            params = self._dense_step(
                params, R, ratings, uid_mat[j], w_mat[j], subs[j]
            )
        state.params = params
        state.step += 1
        return state

    def data_loss(self, state, sample_size: int = 0) -> float:
        return self.inner.data_loss(state, sample_size)

    def penalty_loss(self, state) -> float:
        return self.inner.penalty_loss(state)

    def batch_scores(self, state, uids, rated_items, rated_mask):
        return self._scores(
            state.params,
            jax.device_put(np.asarray(uids, dtype=np.int32),
                           NamedSharding(self.mesh, P("data"))),
        )

    def predict(self, state, users, items):
        return self.inner.predict(state, users, items)


class ShardedFISM(RecsysModel):
    """Dense-slab FISM over the ('data','model') mesh (pointwise only;
    x/bu shard over users, P/Q/bi over items, (B, I) slabs over both).
    Dense mode is mandatory — the sparse per-user step stays single-chip."""

    name = "ShardedFISM"

    def __init__(self, config=None, mesh: Optional[Mesh] = None, **kw):
        from cdae_jax.models.fism import FISM, FISMConfig

        cfg = config if config is not None else FISMConfig(**kw)
        cfg = dataclasses.replace(cfg, dense_mode=True)
        self.inner = FISM(cfg)
        self.cfg = self.inner.cfg
        self.loss = self.inner.loss
        self.mesh = mesh if mesh is not None else make_mesh()
        self._dense_step = None

    def set_learn_rate(self, lr: float) -> None:
        self.inner.set_learn_rate(lr)

    def reset(self, data: Interactions, seed: int = 0):
        from cdae_jax.parallel.mesh import mf_param_specs, shard_params
        from cdae_jax.parallel.sharded import make_sharded_fism_dense_step

        state = self.inner.reset(data, seed)
        if "dense_R" not in state.aux:
            raise ValueError(
                "ShardedFISM requires the dense (U, I) slab budget; use "
                "single-chip FISM for larger catalogs"
            )
        from cdae_jax.parallel.mesh import _fit_spec

        specs = mf_param_specs(state.params)
        state.params = shard_params(self.mesh, state.params, specs)
        R = state.aux["dense_R"]
        state.aux["dense_R"] = jax.device_put(
            R,
            NamedSharding(self.mesh,
                          _fit_spec(self.mesh, P("data", "model"), R.shape)),
        )
        self._dense_step = make_sharded_fism_dense_step(
            self.inner, self.mesh, state.params
        )
        x_spec = _fit_spec(self.mesh, P("data", None),
                           state.params["x"].shape)
        self._rebuild_x = jax.jit(
            lambda R, Pm: R.astype(Pm.dtype) @ Pm,
            out_shardings=NamedSharding(self.mesh, x_spec),
        )
        return state

    def _sharded_dense_batches(self, state):
        if "sharded_dense_batches" not in state.aux:
            sh = NamedSharding(self.mesh, P(None, "data"))
            uid_mat, w_mat = self.inner._dense_user_batches(state)
            state.aux["sharded_dense_batches"] = (
                jax.device_put(uid_mat, sh), jax.device_put(w_mat, sh),
            )
        return state.aux["sharded_dense_batches"]

    def train_one_iteration(self, state, rng_key):
        import jax.numpy as jnp

        R = state.aux["dense_R"]
        uid_mat, w_mat = self._sharded_dense_batches(state)
        lr = jnp.asarray(self.inner._lr, self.cfg.dtype)
        params = state.params
        for j in range(uid_mat.shape[0]):
            rng_key, sub = jax.random.split(rng_key)
            params = self._dense_step(params, R, uid_mat[j], w_mat[j], lr,
                                      sub)
        params["x"] = self._rebuild_x(R, params["P"])
        state.params = params
        state.step += 1
        return state

    def data_loss(self, state, sample_size: int = 0) -> float:
        return self.inner.data_loss(state, sample_size)

    def penalty_loss(self, state) -> float:
        return self.inner.penalty_loss(state)

    def batch_scores(self, state, uids, rated_items, rated_mask):
        return self.inner.batch_scores(state, uids, rated_items, rated_mask)

    def predict(self, state, users, items):
        return self.inner.predict(state, users, items)


class ShardedALS(RecsysModel):
    """ALS/WRMF over the mesh: every row's d×d normal-equation solve is
    independent (ref als.hpp:100-121), so each sweep runs as one shard_map
    over a flat device axis — every device gathers its rows' observed
    factors from the replicated fixed side and solves locally, ZERO
    collectives. Both sweeps (user, then item against the updated user
    factors) stay inside one jitted program per iteration."""

    name = "ShardedALS"
    weighted = False

    def __init__(self, config=None, mesh: Optional[Mesh] = None, **kw):
        from cdae_jax.models.als import ALS, ALSConfig, WRMF

        cfg = config if config is not None else ALSConfig(**kw)
        self.inner = (WRMF if self.weighted else ALS)(cfg)
        self.cfg = self.inner.cfg
        self.loss = self.inner.loss
        self.mesh = mesh if mesh is not None else make_mesh()
        self._devices = [d for d in self.mesh.devices.flat]
        self._iter = None

    def reset(self, data: Interactions, seed: int = 0):
        from cdae_jax.ops.shard_compat import shard_map
        from jax.sharding import Mesh as FlatMesh

        from cdae_jax.models.als import _solve_side_math

        state = self.inner.reset(data, seed)
        nd = len(self._devices)
        flat = FlatMesh(np.array(self._devices), ("blk",))
        weighted = self.inner.weighted

        def stage(pb):
            """Side arrays padded to nd row blocks (not solve_batch chunks:
            each device IS a chunk)."""
            N = pb.num_users
            rows_per = max(-(-N // nd), 1)
            pad = rows_per * nd - N

            def padrows(a, fill=0):
                if pad > 0:
                    shape = (pad,) + a.shape[1:]
                    a = np.concatenate([a, np.full(shape, fill, a.dtype)])
                return jnp.asarray(a)

            return (
                padrows(pb.items, pb.num_items),
                padrows(pb.ratings),
                padrows(pb.mask, False),
                padrows(pb.lengths),
                jnp.asarray(N, jnp.int32),
            )

        state.aux["dev_user_side"] = stage(state.padded)
        state.aux["dev_item_side"] = stage(state.aux["by_item"])

        def sweep(X, Y, side, lam, sc):
            idx, ratings, mask, lens, N = side
            rows_per = idx.shape[0] // nd
            offs = jnp.arange(nd, dtype=jnp.int32) * rows_per

            def local(idx_b, r_b, m_b, len_b, off, Y, Xold_b):
                solved = _solve_side_math(Y, idx_b, r_b, m_b, lam, sc,
                                          weighted,
                                          w_solver=self.cfg.w_solver)
                rid = off[0] + jnp.arange(idx_b.shape[0])
                keep = (len_b > 0) & (rid < N)
                return jnp.where(keep[:, None], solved, Xold_b)

            Xp = jnp.pad(X, ((0, idx.shape[0] - X.shape[0]), (0, 0)))
            out = shard_map(
                local, mesh=flat,
                in_specs=(P("blk", None), P("blk", None), P("blk", None),
                          P("blk"), P("blk"), P(), P("blk", None)),
                out_specs=P("blk", None),
                check_rep=False,
            )(idx, ratings, mask, lens, offs, Y, Xp)
            return out[: X.shape[0]]

        def iteration(p, q, user_side, item_side, lam, sc):
            p = sweep(p, q, user_side, lam, sc)
            q = sweep(q, p, item_side, lam, sc)
            return p, q

        self._iter = jax.jit(iteration, donate_argnums=(0, 1))
        return state

    def train_one_iteration(self, state, rng_key):
        params = dict(state.params)
        params["p"], params["q"] = self._iter(
            params["p"], params["q"],
            state.aux["dev_user_side"], state.aux["dev_item_side"],
            jnp.asarray(self.cfg.lambda_, self.cfg.dtype),
            jnp.asarray(self.cfg.scalar, self.cfg.dtype),
        )
        state.params = params
        state.step += 1
        return state

    def data_loss(self, state, sample_size: int = 0) -> float:
        return self.inner.data_loss(state, sample_size)

    def penalty_loss(self, state) -> float:
        return self.inner.penalty_loss(state)

    def batch_scores(self, state, uids, rated_items, rated_mask):
        return self.inner.batch_scores(state, uids, rated_items, rated_mask)

    def predict(self, state, users, items):
        return self.inner.predict(state, users, items)


class ShardedWRMF(ShardedALS):
    name = "ShardedWRMF"
    weighted = True


class ShardedNegMF(RecsysModel):
    """DP trainer for NegMF's fused scan epoch (per-instance independence,
    ref neg_mf.hpp:79-95): params replicate, each minibatch is constrained
    onto 'data', the FM scatter-gradients reduce with one psum per batch."""

    name = "ShardedNegMF"

    def __init__(self, inner=None, mesh: Optional[Mesh] = None, **kw):
        from cdae_jax.models.linear import FactorModelConfig, NegMF

        if inner is None:
            inner = NegMF(FactorModelConfig(**kw)) if kw else NegMF()
        if not isinstance(inner, NegMF):
            raise TypeError(f"ShardedNegMF wraps NegMF, got {type(inner)}")
        self.inner = inner
        self.cfg = inner.cfg
        self.loss = inner.loss
        self.mesh = mesh if mesh is not None else make_mesh()
        self._jit_epoch = None
        self._epoch_batches = -1

    def _constrain(self, x):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, P("data") if x.ndim == 1
                             else P("data", *([None] * (x.ndim - 1))))
        )

    def reset(self, data: Interactions, seed: int = 0):
        state = self.inner.reset(data, seed)
        state.aux.pop("dense_R", None)  # DP epoch runs the sparse scan path
        rep = NamedSharding(self.mesh, P())
        state.params = {k: jax.device_put(v, rep)
                        for k, v in state.params.items()}
        self._jit_epoch = None
        return state

    def train_one_iteration(self, state, rng_key):
        gi = state.aux["instances"]
        n = len(gi)
        num_batches = max(-(-n // self.cfg.batch_size), 1)
        if self._jit_epoch is None or self._epoch_batches != num_batches:
            fn = self.inner._epoch_fn(
                num_batches, state.num_items, int(gi.group_dims[0]),
                constrain=self._constrain,
            )
            self._jit_epoch = jax.jit(fn, donate_argnums=(0,))
            self._epoch_batches = num_batches
        if "sharded_device_data" not in state.aux:
            rep = NamedSharding(self.mesh, P())
            users, items = state.aux["coo"]
            pb = state.padded
            state.aux["sharded_device_data"] = tuple(
                jax.device_put(np.asarray(a), rep)
                for a in (users, items, pb.items, pb.lengths)
            )
        du, di, dpi, dpl = state.aux["sharded_device_data"]
        import jax.numpy as jnp

        state.params = self._jit_epoch(
            state.params, du, di, dpi, dpl,
            jnp.asarray(state.aux["global_mean"], self.cfg.dtype),
            jnp.asarray(self.inner._lr, self.cfg.dtype),
            rng_key,
        )
        state.step += 1
        return state

    def set_learn_rate(self, lr: float) -> None:
        self.inner.set_learn_rate(lr)

    def data_loss(self, state, sample_size: int = 0) -> float:
        return self.inner.data_loss(state, sample_size)

    def penalty_loss(self, state) -> float:
        return self.inner.penalty_loss(state)

    def batch_scores(self, state, uids, rated_items, rated_mask):
        return self.inner.batch_scores(state, uids, rated_items, rated_mask)

    def predict(self, state, users, items):
        return self.inner.predict(state, users, items)


class ShardedPairwise(RecsysModel):
    """DP trainer for the sparse/fused-epoch MF family (BPR/WARP/IMF/PMF):
    the per-interaction independence of the pairwise updates (ref
    bpr.hpp:72-106 — each pair touches one u row, one i row, nn j rows)
    makes minibatch-axis DP exact up to float summation order.

    Parameters replicate across the mesh; each fused-epoch minibatch is
    forced onto the 'data' axis with a sharding constraint inside the scan
    body (models/mf._epoch_fn), so the pair-gradient one-hot contractions
    partition per pair and GSPMD reduces the aggregated (I, D) / (U, D)
    table gradients with a single psum per batch. The AdaGrad apply then
    runs replicated — every shard steps identically, no parameter traffic.

    Usage: ShardedPairwise(BPR(MFConfig(...)), mesh=make_mesh())
    — drop-in for Solver/Evaluation like the wrapped model.
    """

    name = "ShardedPairwise"

    def __init__(self, inner, mesh: Optional[Mesh] = None):
        from cdae_jax.models.mf import _MFBase

        if not isinstance(inner, _MFBase):
            raise TypeError("ShardedPairwise wraps an _MFBase model "
                            f"(BPR/WARP/IMF/PMF), got {type(inner)}")
        # the factored one-hot contraction partitions cleanly over P
        cfg = inner.cfg
        if cfg.scatter_mode == "auto":
            cfg = dataclasses.replace(cfg, scatter_mode="factored")
        if cfg.row_update is not False:
            # the touched-rows delta path scatters per table — its GSPMD
            # partitioning is unvalidated; the DP epoch keeps the dense
            # apply (ShardedMFTP is the huge-catalog multi-chip trainer)
            cfg = dataclasses.replace(cfg, row_update=False)
        if cfg is not inner.cfg:
            inner = type(inner)(cfg)
        self.inner = inner
        self.cfg = inner.cfg
        self.loss = inner.loss
        self.name = f"Sharded{inner.name}"
        self.mesh = mesh if mesh is not None else make_mesh()
        self._jit_epoch = None
        self._epoch_batches = -1

    def _constrain(self, x):
        from cdae_jax.parallel.mesh import _fit_spec

        spec = _fit_spec(
            self.mesh,
            P("data", *([None] * (x.ndim - 1))), x.shape,
        )
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, spec)
        )

    def reset(self, data: Interactions, seed: int = 0):
        # force the sparse fused-epoch path: dense_mode slabs have their own
        # sharded trainer (ShardedIMF)
        state = self.inner.reset(data, seed)
        state.aux.pop("dense_R", None)
        state.aux.pop("dense_ratings", None)
        rep = NamedSharding(self.mesh, P())
        state.params = {k: jax.device_put(v, rep)
                        for k, v in state.params.items()}
        self._jit_epoch = None
        return state

    def _sharded_device_data(self, state):
        if "sharded_device_data" not in state.aux:
            rep = NamedSharding(self.mesh, P())
            state.aux["sharded_device_data"] = tuple(
                jax.device_put(np.asarray(a), rep)
                for a in (state.aux["coo"][0], state.aux["coo"][1],
                          state.aux["coo"][2], state.padded.items,
                          state.padded.lengths)
            )
        return state.aux["sharded_device_data"]

    def train_one_iteration(self, state, rng_key):
        from cdae_jax.parallel.mesh import _fit_spec

        n = len(state.aux["coo"][0])
        bs = self.cfg.batch_size
        num_batches = max(-(-n // bs), 1)
        if self._jit_epoch is None or self._epoch_batches != num_batches:
            fn = self.inner._epoch_fn(num_batches,
                                      constrain=self._constrain,
                                      external_perm=True)
            self._jit_epoch = jax.jit(fn, donate_argnums=(0,))
            self._epoch_batches = num_batches
        users, items, ratings, pad_items, pad_lengths = (
            self._sharded_device_data(state))
        extras = self.inner._epoch_extras(state)
        rep = NamedSharding(self.mesh, P())
        extras = tuple(jax.device_put(e, rep) for e in extras)
        # same split + permutation the single-chip epoch does internally —
        # but the selection matrices are placed PHYSICALLY sharded over
        # 'data', which is what forces GSPMD to keep the batch distributed
        # (an internal constraint on replicated-derived values is elidable)
        kperm, kstep = jax.random.split(rng_key)
        perm = jax.random.permutation(kperm, n)
        total = num_batches * bs
        if total > n:
            perm = jnp.concatenate([perm, jnp.zeros((total - n,),
                                                    perm.dtype)])
        w_all = (jnp.arange(total) < n).astype(jnp.float32)
        batch_sh = NamedSharding(
            self.mesh, _fit_spec(self.mesh, P(None, "data"), (num_batches,
                                                              bs)))
        sel_mat = jax.device_put(perm.reshape(num_batches, bs), batch_sh)
        w_mat = jax.device_put(w_all.reshape(num_batches, bs), batch_sh)
        from cdae_jax.ops.scatter import batch_axis_mesh

        # trace-time hook: the factored aggregations' contraction over the
        # pair axis runs inside shard_map (local dots + one psum) — the
        # compiler-proof DP for the einsum GSPMD otherwise replicates
        with batch_axis_mesh(self.mesh, "data"):
            state.params = self._jit_epoch(
                state.params, users, items, ratings, pad_items, pad_lengths,
                sel_mat, w_mat, kstep, *extras,
            )
        state.step += 1
        return state

    def data_loss(self, state, sample_size: int = 0) -> float:
        return self.inner.data_loss(state, sample_size)

    def penalty_loss(self, state) -> float:
        return self.inner.penalty_loss(state)

    def batch_scores(self, state, uids, rated_items, rated_mask):
        return self.inner.batch_scores(state, uids, rated_items, rated_mask)

    def predict(self, state, users, items):
        return self.inner.predict(state, users, items)
