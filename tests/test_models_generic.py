"""FISM / FISMPair / LinearModel / FactorModel / NegMF tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cdae_jax.data.dataset import Interactions, movielens_line_parser
from cdae_jax.data.instances import GroupedInstances
from cdae_jax.models.fism import FISM, FISMConfig, FISMPair
from cdae_jax.models.linear import (
    FactorModel, FactorModelConfig, LinearModel, LinearModelConfig, NegMF,
)
from cdae_jax.models.linear import _fm_forward
from cdae_jax.solver.solver import SGDSolver, Solver


@pytest.fixture(scope="module")
def splits(movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    return data.split_by_user(0.2, seed=20141119)


def test_fism_learns(splits):
    train, test = splits
    model = FISM(FISMConfig(num_dim=8, num_neg=3, learn_rate=0.05,
                            batch_size=32))
    solver = SGDSolver(model, max_iteration=10, eval_iterations=10,
                       learn_rate=0.05, seed=0, verbose=False)
    solver.train(train, test, ["TOPN"])
    assert solver.history[-1]["R@10"] > solver.history[0]["R@10"]


def test_fism_x_cache_consistent(splits):
    train, _ = splits
    model = FISM(FISMConfig(num_dim=4, num_neg=2, batch_size=32))
    state = model.reset(train)
    state = model.train_one_iteration(state, jax.random.PRNGKey(0))
    # x_u must equal sum of P rows over rated items after the epoch
    pb = state.padded
    P = np.asarray(state.params["P"])
    x = np.asarray(state.params["x"])
    csr = train.csr()
    for u in [0, 5, 11]:
        np.testing.assert_allclose(
            x[u], P[csr.row(u)].sum(axis=0), rtol=1e-4, atol=1e-6
        )


def test_fism_predict_rated_vs_unrated(splits):
    train, _ = splits
    model = FISM(FISMConfig(num_dim=4, num_neg=0, batch_size=32))
    state = model.reset(train)
    csr = train.csr()
    u = 0
    rated = csr.row(u)
    assert len(rated) >= 1
    unrated = [i for i in range(train.num_items) if i not in set(rated)][0]
    p = state.params
    n = len(rated)
    # manual reference formulas (fism.hpp:198-215)
    x_u = np.asarray(p["x"][u])
    got_rated = float(model.predict(state, [u], [rated[0]])[0])
    exp_rated = (
        float(p["bu"][u]) + float(p["bi"][rated[0]])
        + np.dot(x_u - np.asarray(p["P"][rated[0]]),
                 np.asarray(p["Q"][rated[0]])) / max(n - 1, 1)
    )
    assert got_rated == pytest.approx(exp_rated, rel=1e-4)
    got_un = float(model.predict(state, [u], [unrated])[0])
    exp_un = (
        float(p["bu"][u]) + float(p["bi"][unrated])
        + np.dot(x_u, np.asarray(p["Q"][unrated])) / n
    )
    assert got_un == pytest.approx(exp_un, rel=1e-4)


def test_fism_pair_trains(splits):
    train, test = splits
    model = FISMPair(FISMConfig(num_dim=8, num_neg=2, loss="LOG",
                                learn_rate=0.05, batch_size=32))
    solver = SGDSolver(model, max_iteration=6, eval_iterations=6,
                       learn_rate=0.05, seed=0, verbose=False)
    solver.train(train, test, ["TOPN"])
    assert np.isfinite(solver.history[-1]["R@10"])


def test_linear_model_rmse(splits):
    train, test = splits
    model = LinearModel(LinearModelConfig(learn_rate=0.1, batch_size=64))
    solver = SGDSolver(model, max_iteration=10, eval_iterations=5,
                       learn_rate=0.1, seed=0, verbose=False)
    solver.train(train, test, ["RMSE", "MAE"])
    hist = solver.history
    # training loss decreases; held-out RMSE stays in a sane band (the
    # 240-rating fixture is too small for generalization assertions)
    assert hist[-1]["train_loss"] < hist[1]["train_loss"]
    assert hist[-1]["RMSE"] < 1.5 and hist[-1]["MAE"] < 1.2


def test_data_loss_sample_size(splits):
    """data_loss(sample_size) restricts to the FIRST sample_size instances
    in dataset order (ref linear_model.hpp:45-59 / model_base.hpp:35-39);
    0 = full dataset; models that ignore it still accept the knob."""
    train, _ = splits
    model = LinearModel(LinearModelConfig(learn_rate=0.1, batch_size=64))
    state = model.reset(train, seed=0)
    full = model.data_loss(state)
    assert model.data_loss(state, 0) == full
    sub = model.data_loss(state, 10)
    assert 0.0 < sub < full
    # monotone in sample_size (losses are non-negative per instance)
    assert sub <= model.data_loss(state, 50) <= full
    # oversized sample clamps to the dataset (ref loops min(n, sample))
    assert model.data_loss(state, 10**9) == pytest.approx(full)
    # current_loss forwards the knob
    assert model.current_loss(state, 10) == pytest.approx(
        sub + model.penalty_loss(state))
    # accept-and-ignore surface (ref cdae.hpp:78, neg_mf.hpp:64)
    from cdae_jax.models.cdae import CDAE, CDAEConfig
    cmodel = CDAE(CDAEConfig(num_dim=4, batch_size=32))
    cstate = cmodel.reset(train, seed=0)
    assert cmodel.data_loss(cstate, 10) == pytest.approx(
        cmodel.data_loss(cstate, 0))


def test_factor_model_rmse(splits):
    train, test = splits
    model = FactorModel(FactorModelConfig(num_dim=4, learn_rate=0.1,
                                          batch_size=64))
    solver = SGDSolver(model, max_iteration=10, eval_iterations=5,
                       learn_rate=0.1, seed=0, verbose=False)
    solver.train(train, test, ["RMSE"])
    hist = solver.history
    assert hist[-1]["train_loss"] < hist[1]["train_loss"]
    assert hist[-1]["RMSE"] < 1.5


def test_fm_forward_cross_group_only():
    """Interactions must span groups only (ref factor_model-inl.hpp:54-58)."""
    # 3 slots: slots 0,1 in group 0, slot 2 in group 1
    import jax.numpy as jnp
    params = {
        "w": jnp.zeros((6,)),
        "V": jnp.arange(12, dtype=jnp.float32).reshape(6, 2),
    }
    idx = jnp.asarray([[0, 2, 4]])
    vals = jnp.ones((1, 3))
    out = _fm_forward(params, idx, vals, 0.0, (0, 0, 1))
    V = np.asarray(params["V"])
    # cross-group pairs: (0,4) and (2,4); same-group pair (0,2) excluded
    expect = V[0] @ V[4] + V[2] @ V[4]
    assert float(out[0]) == pytest.approx(expect, rel=1e-5)


def test_negmf_learns(splits):
    train, test = splits
    model = NegMF(FactorModelConfig(num_dim=8, loss="LOG", learn_rate=0.1,
                                    num_neg=3, batch_size=64))
    solver = SGDSolver(model, max_iteration=8, eval_iterations=8,
                       learn_rate=0.1, seed=0, verbose=False)
    solver.train(train, test, ["TOPN"])
    assert solver.history[-1]["R@10"] > solver.history[0]["R@10"]


def test_fism_pair_gradients_match_autodiff(splits):
    """The hand-derived FISMPair update (models/fism._fism_pair_step — incl.
    the k≠i self-term subtraction in the P gradient) must equal autodiff of
    the explicit pair objective with x̃_i = Σ_{k∈R_u} p_k − p_i, at λ=0 with
    plain SGD (ROADMAP: dedicated gradient test for the rebuilt model)."""
    import jax
    import jax.numpy as jnp

    from cdae_jax.models.fism import FISMPair, _fism_pair_step, _scales
    from cdae_jax.ops import sampling
    from cdae_jax.ops.losses import Loss

    train, _ = splits
    cfg_kw = dict(num_dim=4, num_neg=2, loss="LOG", lambda_=0.0,
                  using_adagrad=False, batch_size=8)
    model = FISMPair(FISMConfig(**cfg_kw))
    state = model.reset(train, seed=3)
    pb = state.padded
    B = 8
    uids = jnp.arange(B, dtype=jnp.int32)
    items = jnp.asarray(pb.items[:B])
    mask = jnp.asarray(pb.mask[:B])
    lengths = jnp.asarray(pb.lengths[:B])
    weight = jnp.ones((B,), jnp.float32)
    key = jax.random.PRNGKey(9)
    lr = 1e-3

    p0 = {k: v.copy() for k, v in state.params.items()}
    p1 = _fism_pair_step(
        {k: v.copy() for k, v in p0.items()}, uids, items, mask, lengths,
        weight, lr, key, cfg=model.cfg, loss=model.loss,
    )

    # replicate the step's negative draws, then autodiff the objective
    I, D = p0["P"].shape
    L = items.shape[1]
    nn = model.cfg.num_neg
    neg = sampling.sample_unrated(key, items, lengths, I, nn * L)
    neg_valid = (neg.reshape(B, nn, L) < I).astype(jnp.float32)
    neg_c = jnp.clip(neg.reshape(B, nn, L), 0, I - 1)
    items_c = jnp.clip(items, 0, I - 1)
    mask_f = mask.astype(jnp.float32)
    s_rated, _ = _scales(lengths, model.cfg.alpha, jnp.float32)
    loss = Loss.create("LOG")

    def objective(P, Q, bi):
        x = jnp.einsum("bl,bld->bd", mask_f, P[items_c])
        xt = x[:, None, :] - P[items_c]  # (B, L, D)
        pred_i = (bi[items_c]
                  + jnp.einsum("bld,bld->bl", xt, Q[items_c])
                  * s_rated[:, None])
        pred_j = (bi[neg_c]
                  + jnp.einsum("bld,bnld->bnl", xt, Q[neg_c])
                  * s_rated[:, None, None])
        diff = pred_i[:, None, :] - pred_j
        return jnp.sum(loss.evaluate(diff, 1.0)
                       * mask_f[:, None, :] * neg_valid)

    gP, gQ, gbi = jax.grad(objective, argnums=(0, 1, 2))(
        p0["P"], p0["Q"], p0["bi"]
    )
    for name, g in (("P", gP), ("Q", gQ), ("bi", gbi)):
        got = np.asarray((p0[name] - p1[name]) / lr)
        np.testing.assert_allclose(got, np.asarray(g), rtol=2e-3, atol=2e-5,
                                   err_msg=name)


def test_grouped_instances_from_interactions(splits):
    train, _ = splits
    gi = GroupedInstances.from_interactions(train)
    assert gi.total_dim == train.num_users + train.num_items
    assert gi.idx.shape == (len(train), 2)
    assert (gi.idx[:, 1] >= train.num_users).all()
    np.testing.assert_array_equal(gi.idx[:, 0], train.users)


def test_fism_pair_improves_margins(splits):
    """Pairwise FISM must push positive scores above sampled negatives:
    the mean (pos - mean score) margin grows with training."""
    train, _ = splits
    model = FISMPair(FISMConfig(num_dim=8, num_neg=3, loss="LOG",
                                learn_rate=0.1, batch_size=32))
    state = model.reset(train, seed=0)

    def mean_margin(st):
        pb = st.padded
        uids = np.arange(train.num_users)
        scores = np.asarray(model.batch_scores(st, uids, None, None))
        csr = train.csr()
        margins = []
        for u in uids:
            rated = csr.row(u)
            if len(rated) == 0:
                continue
            pos = scores[u, rated].mean()
            margins.append(pos - scores[u].mean())
        return float(np.mean(margins))

    m0 = mean_margin(state)
    for i in range(6):
        state = model.train_one_iteration(state, jax.random.PRNGKey(i))
    m1 = mean_margin(state)
    assert m1 > m0 + 1e-3, (m0, m1)


def test_fism_dense_step_gradients_match_autodiff(splits):
    """The dense-slab FISM step's matmul-factored gradients (incl. the
    diag(Σ g̃⊙R) self-term corrections in dQ and dP) must equal autodiff of
    the explicit slab objective with x recomputed from P, at λ=0 with plain
    SGD and a FIXED negative-selection mask."""
    import jax
    import jax.numpy as jnp

    from cdae_jax.models.fism import FISM, _fism_dense_step, _scales
    from cdae_jax.ops.losses import Loss

    train, _ = splits
    cfg = FISMConfig(num_dim=4, num_neg=2, loss="SQUARE", lambda_=0.0,
                     using_adagrad=False, batch_size=8, dense_mode=True)
    model = FISM(cfg)
    state = model.reset(train, seed=2)
    R = state.aux["dense_R"]
    B = 8
    uids = jnp.arange(B, dtype=jnp.int32)
    weight = jnp.ones((B,), jnp.float32)
    key = jax.random.PRNGKey(7)
    lr = 1e-3

    p0 = {k: v.copy() for k, v in state.params.items()}
    p1 = _fism_dense_step(
        {k: v.copy() for k, v in p0.items()}, R, uids, weight, lr, key,
        cfg=model.cfg, loss=model.loss,
    )

    # replicate the step's Bernoulli draw, then autodiff the slab objective
    rows = R[uids].astype(jnp.float32)
    I = rows.shape[1]
    lengths = jnp.sum(rows, axis=1)
    s_rated, s_unrated = _scales(lengths, cfg.alpha, jnp.float32)
    p_neg = jnp.clip(cfg.num_neg * lengths / jnp.maximum(I - lengths, 1.0),
                     0.0, 1.0)
    u01 = jax.random.uniform(key, rows.shape)
    neg_sel = (1.0 - rows) * (u01 < p_neg[:, None]).astype(jnp.float32)
    touch = rows + neg_sel
    scale = jnp.where(rows > 0, s_rated[:, None], s_unrated[:, None])
    loss = Loss.create("SQUARE")
    labels = jnp.where(rows > 0, loss.positive_label, loss.negative_label)

    def objective(P, Q, bu, bi):
        x = rows @ P
        base = x @ Q.T
        corr = jnp.sum(P * Q, axis=1)
        pred = (bu[uids][:, None] + bi[None, :]
                + (base - rows * corr[None, :]) * scale)
        return jnp.sum(loss.evaluate(pred, labels) * touch)

    gP, gQ, gbu, gbi = jax.grad(objective, argnums=(0, 1, 2, 3))(
        p0["P"], p0["Q"], p0["bu"], p0["bi"]
    )
    for name, g in (("P", gP), ("Q", gQ), ("bu", gbu), ("bi", gbi)):
        got = np.asarray((p0[name] - p1[name]) / lr)
        np.testing.assert_allclose(got, np.asarray(g), rtol=2e-3, atol=2e-5,
                                   err_msg=name)


def test_fism_dense_learns_and_matches_sparse_quality(splits):
    """Dense-slab FISM reaches the same metric neighborhood as the sparse
    path at equal epochs (Bernoulli negatives, same expected touches)."""
    train, test = splits
    from cdae_jax.evaluation import Evaluation

    ev = Evaluation.create("TOPN")
    out = {}
    for dense in (False, True):
        model = FISM(FISMConfig(num_dim=8, num_neg=3, learn_rate=0.05,
                                batch_size=32, dense_mode=dense))
        solver = SGDSolver(model, max_iteration=10, eval_iterations=10,
                           learn_rate=0.05, seed=0, verbose=False)
        solver.train(train, test, ["TOPN"])
        assert ("dense_R" in solver.state.aux) == dense
        out[dense] = solver.history[-1]["R@10"]
    assert out[True] > 0.0
    assert abs(out[True] - out[False]) < 0.15


def test_negmf_dense_step_gradients_match_autodiff(splits):
    """Dense-slab NegMF gradients (models/linear._negmf_dense_step) == the
    autodiff of the explicit slab objective at λ=0 with plain SGD and the
    same fixed Bernoulli negative mask."""
    import jax
    import jax.numpy as jnp

    from cdae_jax.models.linear import _negmf_dense_step
    from cdae_jax.ops.losses import Loss

    train, _ = splits
    cfg = FactorModelConfig(num_dim=4, num_neg=2, loss="LOG", lambda_=0.0,
                            using_adagrad=False, batch_size=8,
                            using_global_mean=False, dense_mode=True)
    model = NegMF(cfg)
    state = model.reset(train, seed=1)
    R = state.aux["dense_R"]
    i_off = train.num_users
    B = 8
    uids = jnp.arange(B, dtype=jnp.int32)
    weight = jnp.ones((B,), jnp.float32)
    key = jax.random.PRNGKey(3)
    lr = 1e-3
    loss = Loss.create("LOG")

    p0 = {k: v.copy() for k, v in state.params.items()}
    p1 = _negmf_dense_step(
        {k: v.copy() for k, v in p0.items()}, R, uids, weight,
        jnp.float32(0.0), lr, key, cfg=model.cfg, loss=loss, i_off=i_off,
    )

    rows = R[uids].astype(jnp.float32)
    I = rows.shape[1]
    lengths = jnp.sum(rows, axis=1)
    p_neg = jnp.clip(cfg.num_neg * lengths / jnp.maximum(I - lengths, 1.0),
                     0.0, 1.0)
    u01 = jax.random.uniform(key, rows.shape)
    neg_sel = (1.0 - rows) * (u01 < p_neg[:, None]).astype(jnp.float32)
    touch = rows + neg_sel
    labels = jnp.where(rows > 0, 1.0, -1.0)

    def objective(w, V):
        pred = (w[uids][:, None] + w[i_off:i_off + I][None, :]
                + V[uids] @ V[i_off:i_off + I].T)
        return jnp.sum(loss.evaluate(pred, labels) * touch)

    gw, gV = jax.grad(objective, argnums=(0, 1))(p0["w"], p0["V"])
    for name, g in (("w", gw), ("V", gV)):
        got = np.asarray((p0[name] - p1[name]) / lr)
        np.testing.assert_allclose(got, np.asarray(g), rtol=2e-3, atol=2e-5,
                                   err_msg=name)


def test_negmf_dense_learns(splits):
    train, test = splits
    model = NegMF(FactorModelConfig(num_dim=8, loss="LOG", learn_rate=0.1,
                                    num_neg=3, batch_size=64,
                                    dense_mode=True))
    solver = SGDSolver(model, max_iteration=8, eval_iterations=8,
                       learn_rate=0.1, seed=0, verbose=False)
    solver.train(train, test, ["TOPN"])
    assert "dense_R" in solver.state.aux
    assert solver.history[-1]["R@10"] > solver.history[0]["R@10"]


def test_recommend_api_excludes_rated(splits):
    """RecsysModel.recommend (ref recsys_model_base.hpp:77-104): top-k ids
    never include the user's rated items and match a manual masked top-k
    of batch_scores."""
    from cdae_jax.models.mf import IMF, MFConfig

    train, _ = splits
    model = IMF(MFConfig(num_dim=6, num_neg=2, batch_size=64))
    state = model.reset(train, seed=0)
    state = model.train_one_iteration(state, jax.random.PRNGKey(0))

    uids = np.arange(min(8, train.num_users), dtype=np.int32)
    rec = model.recommend(state, uids, train, k=5)
    assert rec.shape == (len(uids), 5)
    pb = train.padded()
    for r, u in zip(rec, uids):
        rated = set(pb.items[u][pb.mask[u]].tolist())
        assert not (set(r.tolist()) & rated), f"user {u} got rated items"
    # manual masked top-k agrees
    from cdae_jax.ops.topk import topk_unrated

    scores = model.batch_scores(state, uids, pb.items[uids], pb.mask[uids])
    want, _ = topk_unrated(jnp.asarray(scores), jnp.asarray(pb.items[uids]), 5)
    np.testing.assert_array_equal(rec, np.asarray(want))
