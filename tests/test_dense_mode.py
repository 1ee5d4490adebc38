"""Dense full-catalog training mode vs the sparse (gather/scatter) path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cdae_jax.data.dataset import Interactions, movielens_line_parser
from cdae_jax.evaluation import Evaluation
from cdae_jax.models.cdae import CDAE, CDAEConfig
from cdae_jax.models.base import iter_user_batches
from cdae_jax.solver.solver import Solver


@pytest.fixture(scope="module")
def data(movielens_path):
    return Interactions.from_text(movielens_path, movielens_line_parser)


# tanh's 1 - z² derivative near saturation magnifies the f32 summation-
# order difference of the two encodes (gather-sum vs matmul), and the first
# AdaGrad step from the 1e-4 init passes it on nearly unscaled
_TOL = dict(rtol=2e-5, atol=1e-6)
_TANH_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("variant,tol", [
    (dict(loss="SQUARE"), _TOL),
    (dict(loss="CE"), _TOL),
    (dict(loss="SQUARE", tanh=True), _TANH_TOL),
    (dict(loss="SQUARE", linear=True), _TOL),
    (dict(loss="SQUARE", asymmetric=True), _TOL),
    (dict(loss="SQUARE", user_factor=False), _TOL),
], ids=["square", "ce", "tanh", "linear", "asymmetric", "no_user_factor"])
def test_dense_step_matches_sparse_no_corruption(data, variant, tol):
    """With corruption off and no negatives, the dense and sparse steps are
    the SAME deterministic math — params must match to float tolerance."""
    train, _ = data.split_by_user(0.2, seed=3)
    cfg = dict(num_dim=8, corruption_ratio=0.0, num_neg=0,
               learn_rate=0.1, lambda_=0.01, batch_size=16,
               bucket_by_length=False, **variant)
    m_sparse = CDAE(CDAEConfig(dense_mode=False, **cfg))
    m_dense = CDAE(CDAEConfig(dense_mode=True, **cfg))
    s_sparse = m_sparse.reset(train, seed=0)
    s_dense = m_dense.reset(train, seed=0)
    # one batch through each path
    b = next(iter_user_batches(s_sparse.padded, 16))
    key = jax.random.PRNGKey(0)
    p_sparse = m_sparse._train_step(
        dict(s_sparse.params),
        jnp.asarray(b.uids), jnp.asarray(b.items), jnp.asarray(b.mask),
        jnp.asarray(b.lengths), jnp.asarray(b.weight), key,
    )
    p_dense = m_dense._dense_step(
        dict(s_dense.params),
        s_dense.aux["dense_R"],
        jnp.asarray(b.uids), jnp.asarray(b.weight), key,
    )
    assert set(p_dense) == set(p_sparse)
    for k in p_sparse:
        np.testing.assert_allclose(
            np.asarray(p_dense[k]), np.asarray(p_sparse[k]),
            err_msg=k, **tol,
        )


def test_dense_mode_learns(data):
    train, test = data.split_by_user(0.2, seed=20141119)
    model = CDAE(CDAEConfig(num_dim=10, loss="SQUARE", corruption_ratio=0.2,
                            num_neg=5, batch_size=32, dense_mode=True))
    state = model.reset(train, seed=1)
    assert "dense_R" in state.aux
    state = model.train_epochs(state, 15, jax.random.PRNGKey(1))
    res = Evaluation.create("TOPN").evaluate(model, state, test, train)
    assert res["R@10"] > 0.3


def test_dense_mode_auto_threshold(data):
    train, _ = data.split_by_user(0.2, seed=1)
    m_auto = CDAE(CDAEConfig(num_dim=4, batch_size=16))
    s = m_auto.reset(train)
    assert "dense_R" in s.aux  # tiny data -> dense auto-on
    m_off = CDAE(CDAEConfig(num_dim=4, batch_size=16, dense_mode=False))
    s2 = m_off.reset(train)
    assert "dense_R" not in s2.aux


def test_dense_solver_end_to_end(data):
    train, test = data.split_by_user(0.2, seed=20141119)
    model = CDAE(CDAEConfig(num_dim=8, loss="SQUARE", corruption_ratio=0.2,
                            num_neg=3, batch_size=32, dense_mode=True))
    solver = Solver(model, max_iteration=8, eval_iterations=8, seed=2,
                    verbose=False)
    solver.train(train, test, ["TOPN"])
    hist = solver.history
    assert np.isfinite(hist[-1]["train_loss"])
    assert hist[-1]["R@10"] > hist[0]["R@10"]


def test_dense_variants(data):
    train, test = data.split_by_user(0.2, seed=5)
    for variant in (dict(asymmetric=True), dict(linear_function=True),
                    dict(tanh=True), dict(user_factor=False)):
        model = CDAE(CDAEConfig(num_dim=6, loss="SQUARE",
                                corruption_ratio=0.3, num_neg=2,
                                batch_size=32, dense_mode=True, **variant))
        state = model.reset(train, seed=0)
        state = model.train_one_iteration(state, jax.random.PRNGKey(0))
        assert np.isfinite(model.data_loss(state))


def test_dense_imf_pmf(data):
    """Dense-mode IMF/PMF train and learn; BPR stays sparse."""
    from cdae_jax.models.mf import BPR, IMF, MFConfig, PMF
    from cdae_jax.solver.solver import Solver

    train, test = data.split_by_user(0.2, seed=20141119)
    model = IMF(MFConfig(num_dim=10, num_neg=5, batch_size=64,
                         dense_mode=True))
    solver = Solver(model, max_iteration=10, eval_iterations=10, seed=0,
                    verbose=False)
    solver.train(train, test, ["TOPN"])
    assert "dense_R" in solver.state.aux
    assert solver.history[-1]["R@10"] > solver.history[0]["R@10"]

    pmf = PMF(MFConfig(num_dim=8, batch_size=64, dense_mode=True))
    s = pmf.reset(train, seed=0)
    assert "dense_ratings" in s.aux
    l0 = pmf.data_loss(s)
    for i in range(5):
        s = pmf.train_one_iteration(s, jax.random.PRNGKey(i))
    assert pmf.data_loss(s) < l0

    bpr = BPR(MFConfig(num_dim=4, batch_size=64, loss="LOG"))
    s2 = bpr.reset(train, seed=0)
    assert "dense_R" not in s2.aux  # pairwise models stay sparse


def test_batch_topk_streaming_matches_scores_path(data):
    """CDAE.batch_topk (streaming) must equal the dense-scores top-10."""
    train, test = data.split_by_user(0.2, seed=20141119)
    model = CDAE(CDAEConfig(num_dim=8, loss="SQUARE", batch_size=32, dense_mode=False))
    state = model.reset(train, seed=1)
    pb = state.padded
    uids = np.arange(8)
    ri, rm = pb.items[uids], pb.mask[uids]
    # force the streaming branch regardless of catalog size
    from cdae_jax.ops.topk import streaming_topk_scores
    from cdae_jax.models.cdae import _hidden
    import jax.numpy as jnp
    from cdae_jax.ops.topk import topk_unrated

    scores = model.batch_scores(state, uids, ri, rm)
    ids_ref, _ = topk_unrated(scores, jnp.asarray(ri), 10)
    z = _hidden(state.params, jnp.asarray(uids), jnp.asarray(ri),
                jnp.asarray(rm), 1.0, model.cfg)
    ids, _ = streaming_topk_scores(z, state.params["W"],
                                   state.params["b_prime"],
                                   jnp.asarray(ri), k=10, block=16)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ids_ref))
    # moderate catalog: batch_topk defers to the scores path
    assert model.batch_topk(state, uids, ri, rm) is None


def test_dense_mode_bf16_slabs_learn(data):
    """compute_dtype=bf16 keeps every (B, I) slab in bf16 (masks exact,
    gradient slab rounded) — training lands in the same recall ballpark
    as f32."""
    train, test = data.split_by_user(0.2, seed=20141119)
    res = {}
    for cdt in (None, jnp.bfloat16):
        model = CDAE(CDAEConfig(num_dim=10, loss="SQUARE",
                                corruption_ratio=0.2, num_neg=5,
                                batch_size=32, dense_mode=True,
                                compute_dtype=cdt))
        state = model.reset(train, seed=1)
        state = model.train_epochs(state, 15, jax.random.PRNGKey(1))
        r = Evaluation.create("TOPN").evaluate(model, state, test, train)
        res[str(cdt)] = r["R@10"]
    assert res["<class 'jax.numpy.bfloat16'>"] > 0.3, res
    vals = list(res.values())
    assert abs(vals[0] - vals[1]) < 0.1, res
