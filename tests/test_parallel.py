"""Sharding layer tests on the virtual 8-device CPU mesh
(SURVEY §4: multi-host tests via xla_force_host_platform_device_count —
capability the reference never had)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cdae_jax.data.dataset import Interactions
from cdae_jax.models.cdae import CDAE, CDAEConfig
from cdae_jax.ops.topk import topk_unrated
from cdae_jax.parallel.mesh import make_mesh, cdae_param_specs
from cdae_jax.parallel.sharded import (
    make_batch, make_sharded_scores, make_sharded_train_step,
    shard_cdae_state,
)
from cdae_jax.parallel.topk import distributed_topk_unrated


def _tiny(num_users=32, num_items=64, seed=0):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, num_users * num_items, 500))
    return Interactions.from_arrays(
        (pairs // num_items).astype(np.int32),
        (pairs % num_items).astype(np.int32),
        num_users=num_users, num_items=num_items,
    )


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    return make_mesh(n_data=4, n_model=2)


def test_make_mesh_shapes():
    m = make_mesh(n_model=2)
    assert m.shape == {"data": 4, "model": 2}
    m = make_mesh()
    assert m.shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError):
        make_mesh(n_data=3)


def test_distributed_topk_matches_single(mesh):
    rng = np.random.default_rng(1)
    B, I, L, K = 8, 64, 6, 10
    scores = jnp.asarray(rng.standard_normal((B, I)).astype(np.float32))
    rated = np.sort(rng.choice(I, size=(B, L), replace=False), axis=1)
    rated = jnp.asarray(rated.astype(np.int32))
    ids_ref, vals_ref = topk_unrated(scores, rated, K)
    ids, vals = distributed_topk_unrated(mesh, scores, rated, K)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(vals_ref),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ids_ref))


def test_sharded_train_step_matches_single_chip(mesh):
    """DP+TP sharding must be numerically exact vs the single-device step."""
    data = _tiny()
    model = CDAE(CDAEConfig(num_dim=16, loss="SQUARE", corruption_ratio=0.3,
                            num_neg=2, batch_size=16))
    state = model.reset(data, seed=0)
    B = 16
    uids, items, mask, lengths, weight = make_batch(
        state.padded, np.arange(B), B
    )
    args = (
        jnp.asarray(uids), jnp.asarray(items), jnp.asarray(mask),
        jnp.asarray(lengths), jnp.asarray(weight), jax.random.PRNGKey(7),
    )
    # the train step donates its params argument — give each call its own copy
    params_np = {k: np.asarray(v) for k, v in state.params.items()}
    ref = model._train_step(
        {k: jnp.asarray(v) for k, v in params_np.items()}, *args
    )

    params_sh = shard_cdae_state(
        mesh, {k: jnp.asarray(v) for k, v in params_np.items()}
    )
    step = make_sharded_train_step(model, mesh, params_sh)
    got = step(params_sh, *args)
    for k in ref:
        np.testing.assert_allclose(
            np.asarray(got[k]), np.asarray(ref[k]), rtol=2e-5, atol=1e-6,
            err_msg=k,
        )


def test_sharded_scores_match(mesh):
    data = _tiny()
    model = CDAE(CDAEConfig(num_dim=16, loss="SQUARE", batch_size=16))
    state = model.reset(data, seed=0)
    B = 16
    uids, items, mask, lengths, weight = make_batch(
        state.padded, np.arange(B), B
    )
    ref = model.batch_scores(state, uids, items, mask)
    params_sh = shard_cdae_state(mesh, state.params)
    fn = make_sharded_scores(model, mesh, params_sh)
    got = fn(params_sh, jnp.asarray(uids), jnp.asarray(items),
             jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=1e-6)


def test_param_specs_cover_all_variants():
    data = _tiny()
    model = CDAE(CDAEConfig(num_dim=8, asymmetric=True, user_factor=True,
                            linear_function=True, batch_size=16))
    state = model.reset(data)
    specs = cdae_param_specs(state.params)
    assert set(specs) == set(state.params)


def test_graft_entry_contract():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.ndim == 2
    g.dryrun_multichip(8)


def test_sharded_trainer_end_to_end(mesh):
    """ShardedCDAE through the full Solver loop matches the single-chip CDAE
    trajectory (same batches, same rng) on the fake 8-device mesh."""
    from cdae_jax.parallel.trainer import ShardedCDAE
    from cdae_jax.solver.solver import Solver

    data = _tiny(num_users=48, num_items=64, seed=2)
    train, test = data.split_by_user(0.25, seed=9)
    # dense_mode off: the sharded trainer runs the sparse step, so the
    # single-chip reference must too for a trajectory match
    cfg = CDAEConfig(num_dim=16, loss="SQUARE", corruption_ratio=0.3,
                     num_neg=2, batch_size=16,
                     dense_mode=False)

    ref_solver = Solver(CDAE(cfg), max_iteration=3, eval_iterations=3,
                        seed=4, verbose=False)
    ref_solver.train(train, test, ["TOPN"])

    sh_solver = Solver(ShardedCDAE(cfg, mesh=mesh), max_iteration=3,
                       eval_iterations=3, seed=4, verbose=False)
    sh_solver.train(train, test, ["TOPN"])

    r, s = ref_solver.history[-1], sh_solver.history[-1]
    assert abs(r["train_loss"] - s["train_loss"]) < 1e-2 * max(
        abs(r["train_loss"]), 1.0
    )
    assert abs(r["R@10"] - s["R@10"]) < 1e-6


def test_sharded_cdae_batch_topk_distributed(mesh):
    """ShardedCDAE.batch_topk (per-shard top-k + 'model'-axis merge) must
    return exactly the masked top-k of its own sharded scores."""
    from cdae_jax.ops.topk import topk_unrated
    from cdae_jax.parallel.trainer import ShardedCDAE

    data = _tiny(num_users=32, num_items=64, seed=8)
    model = ShardedCDAE(CDAEConfig(num_dim=8, loss="SQUARE", batch_size=16, dense_mode=False),
                        mesh=mesh)
    state = model.reset(data, seed=0)
    pb = state.padded
    uids = np.arange(16)
    ri, rm = pb.items[uids], pb.mask[uids]
    scores = model.batch_scores(state, uids, ri, rm)
    ref, _ = topk_unrated(jnp.asarray(np.asarray(scores)),
                          jnp.asarray(ri), 10)
    got = model.batch_topk(state, uids, ri, rm, 10)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_sharded_dense_matches_single_chip(mesh):
    """Item-sharded dense slabs must match the single-chip dense trajectory."""
    from cdae_jax.parallel.trainer import ShardedCDAE
    from cdae_jax.solver.solver import Solver

    data = _tiny(num_users=48, num_items=64, seed=5)
    train, test = data.split_by_user(0.25, seed=3)
    cfg = CDAEConfig(num_dim=16, loss="SQUARE", corruption_ratio=0.3,
                     num_neg=2, batch_size=16,
                     dense_mode=True)

    ref = Solver(CDAE(cfg), max_iteration=3, eval_iterations=3,
                 seed=4, verbose=False)
    ref.train(train, test, ["TOPN"])

    sh = Solver(ShardedCDAE(cfg, mesh=mesh), max_iteration=3,
                eval_iterations=3, seed=4, verbose=False)
    sh.train(train, test, ["TOPN"])

    r, s = ref.history[-1], sh.history[-1]
    assert abs(r["train_loss"] - s["train_loss"]) < 1e-2 * max(
        abs(r["train_loss"]), 1.0
    )
    assert abs(r["R@10"] - s["R@10"]) < 1e-6


def test_sharded_mf_dense_step_matches_single_chip(mesh):
    """Dense IMF step under DP x TP shardings equals the single-device step."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cdae_jax.models.mf import IMF, MFConfig
    from cdae_jax.parallel.mesh import mf_param_specs
    from cdae_jax.parallel.sharded import make_sharded_mf_dense_step

    data = _tiny(num_users=32, num_items=64, seed=3)
    model = IMF(MFConfig(num_dim=16, num_neg=3, batch_size=16,
                         dense_mode=True))
    state = model.reset(data, seed=0)
    R = state.aux["dense_R"]
    uid_mat, w_mat = model._dense_user_batches(state)
    key = jax.random.PRNGKey(5)

    params_np = {k: np.asarray(v) for k, v in state.params.items()}
    ref = model._jit_dense_step(
        {k: jnp.asarray(v) for k, v in params_np.items()},
        R, R, uid_mat[0], w_mat[0], key,
    )

    pspecs = mf_param_specs(state.params)
    params_sh = {
        k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, pspecs[k]))
        for k, v in params_np.items()
    }
    R_sh = jax.device_put(R, NamedSharding(mesh, P("data", "model")))
    step = make_sharded_mf_dense_step(model, mesh, params_sh)
    got = step(params_sh, R_sh, R_sh, uid_mat[0], w_mat[0], key)
    for k in ref:
        np.testing.assert_allclose(
            np.asarray(got[k]), np.asarray(ref[k]), rtol=2e-5, atol=1e-6,
            err_msg=k,
        )


def test_sharded_imf_trainer_end_to_end(mesh):
    """ShardedIMF (ROADMAP r1 Scale item): Solver-driven training on the
    mesh matches single-chip dense IMF bitwise at every step, and the
    sharded scorer feeds the standard evaluator."""
    from cdae_jax.evaluation import Evaluation
    from cdae_jax.models.mf import IMF, MFConfig
    from cdae_jax.parallel.trainer import ShardedIMF

    data = _tiny(num_users=48, num_items=64, seed=7)
    train, test = data.split_by_user(0.25, seed=1)
    cfg = MFConfig(num_dim=8, num_neg=3, batch_size=16, dense_mode=True)

    single = IMF(cfg)
    s_state = single.reset(train, seed=0)
    sharded = ShardedIMF(cfg, mesh=mesh)
    m_state = sharded.reset(train, seed=0)

    key = jax.random.PRNGKey(11)
    for _ in range(3):
        key, sub = jax.random.split(key)
        s_state = single.train_one_iteration(s_state, sub)
        m_state = sharded.train_one_iteration(m_state, sub)
    for k in s_state.params:
        np.testing.assert_allclose(
            np.asarray(m_state.params[k]), np.asarray(s_state.params[k]),
            rtol=2e-5, atol=1e-6, err_msg=k,
        )

    ev = Evaluation.create("TOPN")
    got = ev.evaluate(sharded, m_state, test, train)
    want = ev.evaluate(single, s_state, test, train)
    assert abs(got["R@10"] - want["R@10"]) < 1e-6


@pytest.mark.parametrize("model_name", ["BPR", "WARP"])
def test_sharded_pairwise_matches_single(mesh, model_name):
    """ShardedPairwise (DP over the pair minibatch axis): same key stream
    as the single-chip fused epoch, params must match up to psum
    float-summation order; the wrapped scorer feeds the evaluator."""
    from cdae_jax.evaluation import Evaluation
    from cdae_jax.models import mf as mf_mod
    from cdae_jax.parallel.trainer import ShardedPairwise

    data = _tiny(num_users=48, num_items=64, seed=3)
    train, test = data.split_by_user(0.25, seed=1)
    cfg = mf_mod.MFConfig(num_dim=8, num_neg=2, batch_size=32,
                          scatter_mode="factored", dense_mode=False)
    cls = getattr(mf_mod, model_name)

    single = cls(cfg)
    s_state = single.reset(train, seed=0)
    sharded = ShardedPairwise(cls(cfg), mesh=mesh)
    assert sharded.name == f"Sharded{model_name}"
    m_state = sharded.reset(train, seed=0)

    key = jax.random.PRNGKey(5)
    for _ in range(2):
        key, sub = jax.random.split(key)
        s_state = single.train_one_iteration(s_state, sub)
        m_state = sharded.train_one_iteration(m_state, sub)
    for k in s_state.params:
        np.testing.assert_allclose(
            np.asarray(m_state.params[k]), np.asarray(s_state.params[k]),
            rtol=2e-5, atol=1e-6, err_msg=k,
        )

    ev = Evaluation.create("TOPN")
    got = ev.evaluate(sharded, m_state, test, train)
    want = ev.evaluate(single, s_state, test, train)
    assert abs(got["R@10"] - want["R@10"]) < 1e-5


@pytest.mark.parametrize("model_name", ["IMF", "PMF"])
def test_sharded_mf_tp_pointwise_matches_single(mesh, model_name):
    """ShardedMFTP pointwise family (IMF sampled negatives / PMF ratings):
    same key stream as the single-chip fused epoch, params match up to
    float summation order with the item table sharded P('model')."""
    from cdae_jax.models import mf as mf_mod
    from cdae_jax.parallel.tp_pairwise import ShardedMFTP

    data = _tiny(num_users=48, num_items=64, seed=7)
    train, _ = data.split_by_user(0.25, seed=1)
    cfg = mf_mod.MFConfig(num_dim=8, num_neg=2, batch_size=32,
                          scatter_mode="factored", dense_mode=False)
    cls = getattr(mf_mod, model_name)

    single = cls(cfg)
    s_state = single.reset(train, seed=0)
    tp = ShardedMFTP(cls(cfg), mesh=mesh)
    m_state = tp.reset(train, seed=0)

    key = jax.random.PRNGKey(6)
    for _ in range(2):
        key, sub = jax.random.split(key)
        s_state = single.train_one_iteration(s_state, sub)
        m_state = tp.train_one_iteration(m_state, sub)
    for k in s_state.params:
        np.testing.assert_allclose(
            np.asarray(m_state.params[k]), np.asarray(s_state.params[k]),
            rtol=2e-5, atol=1e-6, err_msg=k,
        )


def test_sharded_mf_tp_rejects_bad_configs(mesh):
    """Batch must divide the 'data' axis; only the sparse MF family is
    TP-shardable (ALS/FISM/NegMF have dedicated trainers)."""
    from cdae_jax.models.als import ALS, ALSConfig
    from cdae_jax.models.mf import BPR, MFConfig
    from cdae_jax.parallel.tp_pairwise import ShardedMFTP

    with pytest.raises(ValueError, match="divide"):
        ShardedMFTP(BPR(MFConfig(num_dim=4, batch_size=30)), mesh=mesh)
    with pytest.raises(TypeError, match="item table"):
        ShardedMFTP(ALS(ALSConfig(num_dim=4)), mesh=mesh)


def test_sharded_imf_tp_no_negatives(mesh):
    """num_neg=0 pointwise branch (pure positives) matches single-chip."""
    from cdae_jax.models.mf import IMF, MFConfig
    from cdae_jax.parallel.tp_pairwise import ShardedMFTP

    data = _tiny(num_users=48, num_items=64, seed=17)
    train, _ = data.split_by_user(0.25, seed=1)
    cfg = MFConfig(num_dim=6, num_neg=0, batch_size=32,
                   scatter_mode="factored", dense_mode=False)
    single = IMF(cfg)
    s_state = single.reset(train, seed=0)
    tp = ShardedMFTP(IMF(cfg), mesh=mesh)
    m_state = tp.reset(train, seed=0)
    key = jax.random.PRNGKey(2)
    s_state = single.train_one_iteration(s_state, key)
    m_state = tp.train_one_iteration(m_state, key)
    for k in s_state.params:
        np.testing.assert_allclose(
            np.asarray(m_state.params[k]), np.asarray(s_state.params[k]),
            rtol=2e-5, atol=1e-6, err_msg=k,
        )


def test_sharded_warp_tp_matches_single_scan_path(mesh):
    """ShardedMFTP(WARP) runs the candidate-scan violator path with the
    same key stream as the single-chip scan epoch (dense_mode=False forces
    the scan path on the single-chip side too): params match up to float
    summation order."""
    from cdae_jax.models.mf import WARP, MFConfig
    from cdae_jax.parallel.tp_pairwise import ShardedMFTP

    data = _tiny(num_users=48, num_items=64, seed=13)
    train, _ = data.split_by_user(0.25, seed=1)
    cfg = MFConfig(num_dim=8, num_neg=2, num_tries=6, batch_size=32,
                   loss="HINGE", lambda_=0.1, beta=0.0,
                   scatter_mode="factored", dense_mode=False)

    single = WARP(cfg)
    s_state = single.reset(train, seed=0)
    tp = ShardedMFTP(WARP(cfg), mesh=mesh)
    m_state = tp.reset(train, seed=0)

    key = jax.random.PRNGKey(8)
    for _ in range(2):
        key, sub = jax.random.split(key)
        s_state = single.train_one_iteration(s_state, sub)
        m_state = tp.train_one_iteration(m_state, sub)
    for k in s_state.params:
        np.testing.assert_allclose(
            np.asarray(m_state.params[k]), np.asarray(s_state.params[k]),
            rtol=2e-5, atol=1e-6, err_msg=k,
        )


def test_sharded_pairwise_tp_matches_single(mesh):
    """ShardedPairwiseTP (item table PHYSICALLY sharded over 'model',
    batch over 'data'): same key stream as the single-chip fused epoch,
    params match up to float summation order; item blocks carry the
    n_model padding and scoring slices it off. num_items=63 exercises a
    non-divisible catalog (pad row must stay zero / never be recommended)."""
    from cdae_jax.evaluation import Evaluation
    from cdae_jax.models.mf import BPR, MFConfig
    from cdae_jax.parallel.tp_pairwise import ShardedPairwiseTP

    data = _tiny(num_users=48, num_items=63, seed=3)
    train, test = data.split_by_user(0.25, seed=1)
    cfg = MFConfig(num_dim=8, num_neg=2, batch_size=32,
                   scatter_mode="factored", dense_mode=False)

    single = BPR(cfg)
    s_state = single.reset(train, seed=0)
    tp = ShardedPairwiseTP(BPR(cfg), mesh=mesh)
    assert tp.name == "ShardedBPRTP"
    m_state = tp.reset(train, seed=0)

    # item tables padded to n_model row blocks and sharded over 'model'
    nm = mesh.shape["model"]
    assert m_state.params["iv"].shape[0] == -(-63 // nm) * nm
    spec = m_state.params["iv"].sharding.spec
    assert spec[0] == "model"

    key = jax.random.PRNGKey(5)
    for _ in range(2):
        key, sub = jax.random.split(key)
        s_state = single.train_one_iteration(s_state, sub)
        m_state = tp.train_one_iteration(m_state, sub)
    for k in s_state.params:
        got = np.asarray(m_state.params[k])
        if got.shape[0] != s_state.params[k].shape[0]:
            if not k.endswith("_ag"):
                assert not np.any(got[63:]), k  # pad rows stay exactly zero
            else:
                assert np.all(got[63:] > 0), k  # ADAGRAD_INIT pad kept
            got = got[:63]
        np.testing.assert_allclose(
            got, np.asarray(s_state.params[k]),
            rtol=2e-5, atol=1e-6, err_msg=k,
        )

    ev = Evaluation.create("TOPN")
    got = ev.evaluate(tp, m_state, test, train)
    want = ev.evaluate(single, s_state, test, train)
    assert abs(got["R@10"] - want["R@10"]) < 1e-5
    # scores slice the padding off: exactly the real catalog width
    scores = tp.batch_scores(m_state, np.arange(4), None, None)
    assert scores.shape[1] == 63

    # distributed batch_topk == masked top-k of the gathered scores, incl.
    # a batch size that does NOT divide the 'data' axis (internal padding)
    from cdae_jax.ops.topk import topk_unrated

    pb = train.padded()
    uids = np.arange(7, dtype=np.int32)
    rec = tp.batch_topk(m_state, uids, pb.items[uids], pb.mask[uids], 5)
    s = tp.batch_scores(m_state, uids, pb.items[uids], pb.mask[uids])
    want, _ = topk_unrated(jnp.asarray(s), jnp.asarray(pb.items[uids]), 5)
    np.testing.assert_array_equal(rec, np.asarray(want))


def test_sharded_negmf_matches_single(mesh):
    """ShardedNegMF: same key stream as single-chip NegMF's fused epoch,
    params match up to psum summation order."""
    from cdae_jax.models.linear import FactorModelConfig, NegMF
    from cdae_jax.parallel.trainer import ShardedNegMF

    data = _tiny(num_users=48, num_items=64, seed=9)
    train, _ = data.split_by_user(0.25, seed=1)
    cfg = FactorModelConfig(num_dim=6, num_neg=2, loss="LOG",
                            batch_size=32, using_global_mean=False,
                            dense_mode=False)  # sharded epoch = sparse path

    single = NegMF(cfg)
    s_state = single.reset(train, seed=0)
    sharded = ShardedNegMF(NegMF(cfg), mesh=mesh)
    m_state = sharded.reset(train, seed=0)

    key = jax.random.PRNGKey(4)
    for _ in range(2):
        key, sub = jax.random.split(key)
        s_state = single.train_one_iteration(s_state, sub)
        m_state = sharded.train_one_iteration(m_state, sub)
    for k in s_state.params:
        np.testing.assert_allclose(
            np.asarray(m_state.params[k]), np.asarray(s_state.params[k]),
            rtol=2e-5, atol=1e-6, err_msg=k,
        )


def test_sharded_fism_matches_single(mesh):
    """ShardedFISM dense slabs: same key stream as single-chip dense FISM,
    params (incl. the x cache) match up to psum summation order."""
    from cdae_jax.models.fism import FISM, FISMConfig
    from cdae_jax.parallel.trainer import ShardedFISM

    data = _tiny(num_users=48, num_items=64, seed=11)
    train, _ = data.split_by_user(0.25, seed=1)
    cfg = FISMConfig(num_dim=6, num_neg=2, batch_size=16, dense_mode=True)

    single = FISM(cfg)
    s_state = single.reset(train, seed=0)
    sharded = ShardedFISM(cfg, mesh=mesh)
    m_state = sharded.reset(train, seed=0)

    key = jax.random.PRNGKey(6)
    for _ in range(2):
        key, sub = jax.random.split(key)
        s_state = single.train_one_iteration(s_state, sub)
        m_state = sharded.train_one_iteration(m_state, sub)
    for k in s_state.params:
        np.testing.assert_allclose(
            np.asarray(m_state.params[k]), np.asarray(s_state.params[k]),
            rtol=2e-5, atol=1e-6, err_msg=k,
        )


def test_sharded_neighbor_build_matches_serial(mesh):
    """Mesh-parallel similarity neighbor build == the serial block loop
    exactly (same dots, row-independent top-k)."""
    from cdae_jax.models.similarity import (
        build_topk_neighbors, build_topk_neighbors_sharded,
    )

    rng = np.random.default_rng(2)
    binary = (rng.random((100, 70)) < 0.1).astype(np.int8)
    for sim in ("JACCARD", "COSINE"):
        ids_s, sims_s = build_topk_neighbors(binary, sim, 10, block_size=32)
        ids_p, sims_p = build_topk_neighbors_sharded(binary, sim, 10)
        np.testing.assert_array_equal(ids_p, ids_s)
        np.testing.assert_allclose(sims_p, sims_s, rtol=1e-6)


@pytest.mark.parametrize("name", ["ShardedALS", "ShardedWRMF"])
def test_sharded_als_matches_single(mesh, name):
    """ShardedALS/WRMF sweeps (row-block shard_map solves) match the
    single-chip fused iteration."""
    from cdae_jax.models.als import ALS, ALSConfig, WRMF
    from cdae_jax.parallel import trainer as tr

    data = _tiny(num_users=48, num_items=64, seed=13)
    train, _ = data.split_by_user(0.25, seed=1)
    cfg = ALSConfig(num_dim=6, lambda_=0.1, scalar=5.0, solve_batch=16)
    single_cls = WRMF if name == "ShardedWRMF" else ALS

    single = single_cls(cfg)
    s_state = single.reset(train, seed=0)
    sharded = getattr(tr, name)(cfg, mesh=mesh)
    m_state = sharded.reset(train, seed=0)

    for _ in range(2):
        s_state = single.train_one_iteration(s_state, None)
        m_state = sharded.train_one_iteration(m_state, None)
    for k in s_state.params:
        np.testing.assert_allclose(
            np.asarray(m_state.params[k]), np.asarray(s_state.params[k]),
            rtol=5e-4, atol=1e-6, err_msg=k,
        )
