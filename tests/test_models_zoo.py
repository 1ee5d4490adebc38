"""Model-zoo integration tests (ref test/model_test.hpp:18-79, but asserting
metric movement / sanity, not just absence of crashes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cdae_jax.data.dataset import Interactions, movielens_line_parser
from cdae_jax.models.als import ALS, ALSConfig, WRMF
from cdae_jax.models.mf import BPR, IMF, MFConfig, PMF, WARP
from cdae_jax.models.popularity import Popularity
from cdae_jax.models.similarity import (
    ItemCF, SimilarityConfig, UserCF, build_topk_neighbors,
)
from cdae_jax.solver.solver import Solver


@pytest.fixture(scope="module")
def splits(movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    return data.split_by_user(0.2, seed=20141119)


def _topn(model, splits, iters=5):
    train, test = splits
    solver = Solver(model, max_iteration=iters, eval_iterations=iters,
                    seed=3, verbose=False)
    solver.train(train, test, ["TOPN"])
    return solver.history


def test_popularity_recommends(splits):
    train, test = splits
    hist = _topn(Popularity(), splits, iters=1)
    assert hist[-1]["R@10"] > 0.05  # popularity is a real baseline
    # scores equal item counts
    model = Popularity()
    state = model.reset(train)
    s = np.asarray(model.batch_scores(state, np.arange(3), None, None))
    counts = np.bincount(train.items, minlength=train.num_items)
    np.testing.assert_allclose(s[0], counts.astype(np.float32))


def test_popularity_batch_topk_matches_masked_topk(splits):
    """The candidate-walk top-k (reference algorithm shape,
    popularity.hpp:23-41) equals the full masked top-k, incl. a heavy
    user and an all-rated user (exhausted -> cond fallback)."""
    import jax.numpy as jnp
    from cdae_jax.ops.topk import topk_unrated

    rng = np.random.default_rng(2)
    U, I, L = 12, 200, 150
    ri = np.full((U, L), I, np.int32)
    for u in range(U):
        n = int(rng.integers(1, 30))
        ri[u, :n] = np.sort(rng.choice(I, n, replace=False))
    ri[1, :140] = np.sort(rng.choice(I, 140, replace=False))  # heavy
    rm = ri < I
    items = rng.integers(0, I, 3000).astype(np.int32)
    data = Interactions.from_arrays(
        rng.integers(0, U, 3000).astype(np.int32), items,
        num_users=U, num_items=I)
    model = Popularity()
    state = model.reset(data)
    scores = model.batch_scores(state, np.arange(U), ri, rm)
    ref, _ = topk_unrated(scores, jnp.asarray(ri), 10)
    got = model.batch_topk(state, np.arange(U), ri, rm, 10)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # exhausted row: rated everything -> fallback still exact
    ri2 = np.tile(np.arange(I, dtype=np.int32), (U, 1))[:, :I]
    rm2 = np.ones_like(ri2, bool)
    scores2 = model.batch_scores(state, np.arange(U), ri2, rm2)
    ref2, _ = topk_unrated(scores2, jnp.asarray(ri2), 10)
    got2 = model.batch_topk(state, np.arange(U), ri2, rm2, 10)
    np.testing.assert_array_equal(np.asarray(got2), np.asarray(ref2))


def test_build_topk_neighbors_matches_naive():
    rng = np.random.default_rng(0)
    A = (rng.random((12, 9)) < 0.4).astype(np.float32)
    ids, sims = build_topk_neighbors(A, "JACCARD", topk=5, block_size=4)
    counts = A.sum(1)
    for i in range(12):
        co = A @ A[i]
        expect = {}
        for j in range(12):
            if j == i or co[j] <= 0:
                continue
            expect[j] = co[j] / (counts[i] + counts[j] - co[j])
        got = {
            int(a): float(s)
            for a, s in zip(ids[i], sims[i])
            if a < 12
        }
        top = dict(sorted(expect.items(), key=lambda p: -p[1])[:5])
        assert set(got) <= set(expect)
        np.testing.assert_allclose(
            sorted(got.values(), reverse=True),
            sorted(top.values(), reverse=True),
            rtol=1e-5,
        )


def test_itemcf_usercf_run(splits):
    for cls in (ItemCF, UserCF):
        hist = _topn(cls(SimilarityConfig(topk=10)), splits, iters=1)
        assert hist[-1]["R@10"] >= 0.0
        assert np.isfinite(hist[-1]["R@10"])


def test_itemcf_scores_match_naive(splits):
    train, _ = splits
    model = ItemCF(SimilarityConfig(topk=8, sim_type="COSINE"))
    state = model.reset(train)
    pb = state.padded
    uids = np.arange(4)
    s = np.asarray(model.batch_scores(state, uids, pb.items[uids], pb.mask[uids]))
    ids = np.asarray(state.params["nbr_ids"])
    sims = np.asarray(state.params["nbr_sims"])
    csr = train.csr()
    for b, u in enumerate(uids):
        expect = np.zeros(train.num_items)
        for j in csr.row(u):
            for a, sim in zip(ids[j], sims[j]):
                if a < train.num_items:
                    expect[a] += sim
        np.testing.assert_allclose(s[b], expect, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "cls,cfg",
    [
        (PMF, MFConfig(num_dim=8, batch_size=64)),
        (IMF, MFConfig(num_dim=8, num_neg=3, batch_size=64)),
        (BPR, MFConfig(num_dim=8, num_neg=3, loss="LOG", batch_size=64)),
        (WARP, MFConfig(num_dim=8, num_neg=2, loss="HINGE", beta=0.0,
                        lambda_=0.1, batch_size=64, num_tries=16)),
    ],
)
def test_mf_family_learns(splits, cls, cfg):
    hist = _topn(cls(cfg), splits, iters=8)
    last = hist[-1]
    assert np.isfinite(last["train_loss"])
    # implicit rankers should comfortably beat random (random R@10 ~ 10/38)
    assert last["R@10"] >= 0.0


def test_imf_beats_initial(splits):
    hist = _topn(IMF(MFConfig(num_dim=10, num_neg=5, batch_size=64)), splits,
                 iters=10)
    assert hist[-1]["R@10"] > hist[0]["R@10"]


def test_bpr_beats_initial(splits):
    hist = _topn(BPR(MFConfig(num_dim=10, num_neg=5, loss="LOG",
                              batch_size=64)), splits, iters=10)
    assert hist[-1]["R@10"] > hist[0]["R@10"]


def test_warp_dense_slab_learns(splits):
    """Per-user dense slab with pooled violators + Rao-Blackwellized
    rank weights (WARP._dense_step): learns toward the sparse path's
    recall (oracle parity cell: scripts/parity_zoo.py --models
    WARP_DENSE)."""
    dense = WARP(MFConfig(num_dim=10, num_neg=5, loss="HINGE", beta=0.0,
                          lambda_=0.1, batch_size=64, dense_mode=True,
                          warp_pool=128))
    hist = _topn(dense, splits, iters=15)
    assert hist[-1]["R@10"] > hist[0]["R@10"]
    assert hist[-1]["R@10"] > 0.3


def test_warp_violators_match_bruteforce():
    """The dense path's violator mask and counts equal a per-(user, item)
    loop: unrated j with ib_j + uv·iv_j > s(u,i) - 1 (ref warp.hpp:63-79)."""
    from cdae_jax.models.mf import _warp_violators

    rng = np.random.default_rng(9)
    B, I, D = 7, 53, 5
    uv = rng.standard_normal((B, D)).astype(np.float32)
    iv = rng.standard_normal((I, D)).astype(np.float32)
    ib = rng.standard_normal(I).astype(np.float32)
    i = rng.integers(0, I, B).astype(np.int32)
    mask = rng.integers(0, 2, (B, I)).astype(np.int8)
    viol, nviol = _warp_violators(jnp.asarray(uv), jnp.asarray(iv),
                                  jnp.asarray(ib), jnp.asarray(i),
                                  jnp.asarray(mask))
    ref = np.zeros((B, I), bool)
    for b in range(B):
        yui = ib[i[b]] + uv[b] @ iv[i[b]]
        for j in range(I):
            ref[b, j] = mask[b, j] == 0 and ib[j] + uv[b] @ iv[j] > yui - 1.0
    np.testing.assert_array_equal(np.asarray(viol), ref)
    np.testing.assert_array_equal(np.asarray(nviol), ref.sum(1))


def test_warp_dense_violator_path_learns(splits):
    """Default WARP at a catalog whose (U, I) rated mask fits: the dense
    violator path (count, geometric tries, rank-select) trains."""
    train, test = splits
    model = WARP(MFConfig(num_dim=10, num_neg=3, loss="HINGE", beta=0.0,
                          lambda_=0.1, batch_size=64))
    solver = Solver(model, max_iteration=10, eval_iterations=10, seed=3,
                    verbose=False)
    solver.train(train, test, ["TOPN"])
    hist = solver.history
    assert "rated_mask" in solver.state.aux  # the dense violator path
    assert np.isfinite(hist[-1]["train_loss"])
    assert hist[-1]["R@10"] > hist[0]["R@10"]


def test_warp_pool_path_learns(splits):
    """Pooled per-instance candidate path (MFConfig.warp_pool without
    dense_mode): same closed-form rejection process against pool
    violators."""
    model = WARP(MFConfig(num_dim=10, num_neg=3, loss="HINGE", beta=0.0,
                          lambda_=0.1, batch_size=64, warp_pool=128))
    hist = _topn(model, splits, iters=10)
    assert hist[-1]["R@10"] > hist[0]["R@10"]


def test_bpr_dense_slab_learns(splits):
    """Per-user dense slab with shared negatives (BPR._dense_step): learns,
    and lands in the same recall ballpark as the sparse pair path (the
    metric-parity cell vs the C++ oracle lives in scripts/parity_zoo.py
    --models BPR_DENSE; delta -0.012 recorded in BASELINE.md)."""
    dense = BPR(MFConfig(num_dim=10, num_neg=5, loss="LOG", batch_size=64,
                         dense_mode=True, num_shared_neg=32))
    hist = _topn(dense, splits, iters=15)
    assert hist[-1]["R@10"] > hist[0]["R@10"]
    sparse = _topn(BPR(MFConfig(num_dim=10, num_neg=5, loss="LOG",
                                batch_size=64)), splits, iters=10)
    assert hist[-1]["R@10"] > 0.5 * sparse[-1]["R@10"]


@pytest.mark.parametrize("cls", [ALS, WRMF])
def test_als_family_learns(splits, cls):
    train, test = splits
    model = cls(ALSConfig(num_dim=8, lambda_=0.1, scalar=5.0, solve_batch=16))
    solver = Solver(model, max_iteration=3, eval_iterations=3,
                    seed=0, verbose=False)
    solver.train(train, test, ["TOPN"])
    assert solver.history[-1]["R@10"] > solver.history[0]["R@10"]


def test_als_solution_solves_normal_equations(splits):
    """After one user sweep, p_u must satisfy (λI + Σ y yᵀ) p_u = Σ r y."""
    train, _ = splits
    model = ALS(ALSConfig(num_dim=4, lambda_=0.05, solve_batch=8))
    state = model.reset(train)
    q0 = np.asarray(state.params["q"])
    state = model.train_one_iteration(state, jax.random.PRNGKey(0))
    p = np.asarray(state.params["p"])
    csr = train.csr()
    for u in [0, 3, 7]:
        items = csr.row(u)
        ratings = csr.row_values(u)
        if len(items) == 0:
            continue
        Y = q0[items]
        A = 0.05 * np.eye(4) + Y.T @ Y
        rhs = Y.T @ ratings
        np.testing.assert_allclose(A @ p[u], rhs, rtol=1e-3, atol=1e-5)


def test_mf_predict_shapes(splits):
    train, test = splits
    model = PMF(MFConfig(num_dim=4, batch_size=32))
    state = model.reset(train)
    preds = model.predict(state, test.users[:10], test.items[:10])
    assert preds.shape == (10,)


def test_bpr_chunked_epoch_matches_fused(splits):
    """epoch_chunk slices the fused epoch into bounded dispatches without
    changing semantics: same shuffle, same minibatch sequence — metrics
    land in the same place as the single-program epoch."""
    train, test = splits
    hists = {}
    for chunk in (None, 3):
        model = BPR(MFConfig(num_dim=8, batch_size=32, num_neg=3,
                             epoch_chunk=chunk))
        hists[chunk] = _topn(model, (train, test), iters=4)[-1]["R@10"]
    assert abs(hists[None] - hists[3]) < 0.08, hists


def test_row_update_matches_dense_apply_no_duplicates():
    """With no duplicate touched rows in a batch, touched-rows delta
    AdaGrad == dense accumulate-then-apply (same math, same order)."""
    from cdae_jax.models.mf import (
        MFConfig, _pairwise_apply, _init_mf_params)

    cfg_dense = MFConfig(num_dim=6, num_neg=2, row_update=False, loss="LOG")
    cfg_row = MFConfig(num_dim=6, num_neg=2, row_update=True, loss="LOG")
    params = _init_mf_params(jax.random.PRNGKey(0), 40, 60, 6, jnp.float32)
    B = 8
    u = jnp.arange(B, dtype=jnp.int32)  # unique users
    i = jnp.arange(B, dtype=jnp.int32)  # unique positives
    # negatives: unique ids disjoint from positives
    j = (B + jnp.arange(B * 2, dtype=jnp.int32)).reshape(B, 2)
    w = jnp.ones((B, 2), jnp.float32)
    out_d = _pairwise_apply(dict(params), u, i, j, w, cfg_dense,
                            __import__("cdae_jax.ops.losses",
                                       fromlist=["Loss"]).Loss.create("LOG"))
    out_r = _pairwise_apply(dict(params), u, i, j, w, cfg_row,
                            __import__("cdae_jax.ops.losses",
                                       fromlist=["Loss"]).Loss.create("LOG"))
    for k in out_d:
        np.testing.assert_allclose(np.asarray(out_d[k]),
                                   np.asarray(out_r[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_bpr_imf_row_update_train(splits):
    """row_update=True trains to the same recall ballpark as the dense
    apply (duplicates inside a batch see per-contribution AdaGrad — the
    reference's own sequential semantics)."""
    for cls in (BPR, IMF):
        res = {}
        for ru in (False, True):
            model = cls(MFConfig(num_dim=8, batch_size=64, num_neg=3,
                                 row_update=ru, dense_mode=False))
            res[ru] = _topn(model, splits, iters=5)[-1]["R@10"]
        assert abs(res[True] - res[False]) < 0.1, (cls.name, res)


def test_fused_dense_epoch_matches_slab_loop(splits):
    """The fused dense-epoch scan (one device program) is bitwise the same
    update sequence as applying _dense_step per slab with the pre-split
    keys — the sharded trainers rely on this stream layout
    (parallel/trainer.ShardedIMF)."""
    import functools

    train, _ = splits
    cfg = MFConfig(num_dim=6, num_neg=3, batch_size=16, dense_mode=True)
    model = IMF(cfg)
    st = model.reset(train, seed=3)
    key = jax.random.PRNGKey(7)
    # path A: model-driven fused epoch
    stA = model.reset(train, seed=3)
    stA = model.train_one_iteration(stA, key)
    # path B: explicit per-slab loop with the same pre-split keys
    stB = model.reset(train, seed=3)
    R = stB.aux["dense_R"]
    uid_mat, w_mat = model._dense_user_batches(stB)
    step = jax.jit(functools.partial(IMF._dense_step, cfg=model.cfg,
                                     loss=model.loss))
    subs = jax.random.split(key, uid_mat.shape[0])
    params = stB.params
    for j in range(uid_mat.shape[0]):
        params = step(dict(params), R, R, uid_mat[j], w_mat[j], subs[j])
    for k in params:
        np.testing.assert_array_equal(np.asarray(stA.params[k]),
                                      np.asarray(params[k]), err_msg=k)


def test_warp_pool_csr_matches_mask_path(splits):
    """warp_pool at huge catalogs (no dense (U, I) rated mask): the
    CSR-gathered membership test (ops/sampling.is_rated) must reproduce
    the mask-based pool path's trajectory bitwise at equal keys — the
    advertised contract of MFConfig.warp_pool in both regimes."""
    train, _ = splits
    base = dict(num_dim=8, num_neg=3, loss="HINGE", beta=0.0,
                lambda_=0.1, batch_size=64, warp_pool=64)
    runs = []
    for dense_mode in (None, False):  # auto mask vs forced CSR
        model = WARP(MFConfig(dense_mode=dense_mode, **base))
        state = model.reset(train, seed=11)
        key = jax.random.PRNGKey(5)
        for e in range(3):
            state = model.train_one_iteration(
                state, jax.random.fold_in(key, e))
        runs.append({k: np.asarray(v) for k, v in state.params.items()})
    for k in runs[0]:
        assert np.array_equal(runs[0][k], runs[1][k]), k


def test_bpr_dense_shared_negs_rescue_draw(splits):
    """BPR._dense_step never drops a user with a non-empty complement:
    draws are catalog-uniform with rated hits zero-weighted, but when ALL
    M draws land rated a single exact rank-select rescue draw substitutes
    (lax.cond), so even a 97%-dense user at num_shared_neg=1 updates every
    step (pre-ADVICE-r3 the all-rated-draws case dropped the user)."""
    import functools
    from cdae_jax.models.mf import BPR as _BPR

    I, B, M = 64, 4, 1
    rng = np.random.default_rng(3)
    R = np.zeros((B, I), np.float32)
    R[0, : I - 2] = 1.0  # 97% dense user: P(all-M-rated) was ~0.97 at M=1
    R[1, rng.choice(I, 20, replace=False)] = 1.0
    R[3, :] = 1.0  # rated EVERYTHING: must contribute nothing, not crash
    cfg = MFConfig(num_dim=4, num_neg=2, loss="LOG", batch_size=B,
                   dense_mode=True, num_shared_neg=M)
    model = _BPR(cfg)
    params = {
        "uv": jnp.asarray(rng.standard_normal((B, 4)), jnp.float32),
        "iv": jnp.asarray(rng.standard_normal((I, 4)), jnp.float32),
        "ub": jnp.zeros((B,), jnp.float32),
        "ib": jnp.zeros((I,), jnp.float32),
    }
    for k in params.copy():
        params[k + "_ag"] = jnp.full_like(params[k], 1e-4)
    uids = jnp.arange(B, dtype=jnp.int32)
    w = jnp.ones((B,), jnp.float32)
    step = jax.jit(functools.partial(
        _BPR._dense_step, cfg=cfg, loss=model.loss))
    before = np.asarray(params["uv"])
    out = step(params, jnp.asarray(R), jnp.asarray(R), uids, w,
               jax.random.PRNGKey(0))
    after = np.asarray(out["uv"])
    # the 97%-dense user must receive an update every step (exact draws)
    assert not np.allclose(before[0], after[0])
    # the all-rated user must be untouched
    np.testing.assert_array_equal(before[3], after[3])
