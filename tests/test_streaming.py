"""CSR streaming batcher vs full-padded equivalence + streamed CDAE."""

import jax
import numpy as np
import pytest

from cdae_jax.data.dataset import Interactions, movielens_line_parser
from cdae_jax.models.base import iter_user_batches, iter_user_batches_csr
from cdae_jax.models.cdae import CDAE, CDAEConfig
from cdae_jax.solver.solver import Solver


@pytest.fixture(scope="module")
def data(movielens_path):
    return Interactions.from_text(movielens_path, movielens_line_parser)


def test_csr_batches_match_padded(data):
    pb = data.padded()
    a = list(iter_user_batches(pb, 8, bucket_by_length=True))
    b = list(iter_user_batches_csr(data.csr(), data.num_items, 8,
                                   bucket_by_length=True))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.uids, y.uids)
        np.testing.assert_array_equal(x.lengths, y.lengths)
        np.testing.assert_array_equal(x.weight, y.weight)
        L = min(x.items.shape[1], y.items.shape[1])
        # real entries agree; both pad with num_items beyond lengths
        np.testing.assert_array_equal(
            np.where(x.mask[:, :L], x.items[:, :L], -1),
            np.where(y.mask[:, :L], y.items[:, :L], -1),
        )


def test_streamed_cdae_matches_padded_cdae(data):
    train, test = data.split_by_user(0.2, seed=5)
    results = []
    for stream in (False, True):
        model = CDAE(CDAEConfig(num_dim=6, loss="SQUARE", batch_size=16,
                                corruption_ratio=0.2, stream_batches=stream))
        solver = Solver(model, max_iteration=4, eval_iterations=4,
                        seed=3, verbose=False)
        solver.train(train, test, ["TOPN"])
        results.append(solver.history[-1])
        assert (model is not None) and (
            (solver.state.padded is None) == stream
        )
    # identical batches + identical rng => identical training trajectory
    assert results[0]["train_loss"] == results[1]["train_loss"]
    assert results[0]["R@10"] == results[1]["R@10"]


def test_streamed_predict_and_representations(data):
    train, _ = data.split_by_user(0.2, seed=5)
    m_pad = CDAE(CDAEConfig(num_dim=5, batch_size=16, stream_batches=False))
    m_str = CDAE(CDAEConfig(num_dim=5, batch_size=16, stream_batches=True))
    s_pad = m_pad.reset(train, seed=0)
    s_str = m_str.reset(train, seed=0)
    users = np.array([0, 3, 7, 11])
    items = np.array([1, 5, 2, 0])
    np.testing.assert_allclose(
        np.asarray(m_pad.predict(s_pad, users, items)),
        np.asarray(m_str.predict(s_str, users, items)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        m_pad.user_representations(s_pad),
        m_str.user_representations(s_str),
        rtol=1e-6,
    )


def test_train_epochs_learns_like_iterations(data):
    """Fused multi-epoch program must reach the same quality as the
    per-iteration path (same model family, same budget)."""
    from cdae_jax.evaluation import Evaluation

    train, test = data.split_by_user(0.2, seed=7)
    ev = Evaluation.create("TOPN")

    cfg = CDAEConfig(num_dim=8, loss="SQUARE", corruption_ratio=0.2,
                     batch_size=16)
    m1 = CDAE(cfg)
    s1 = m1.reset(train, seed=2)
    for i in range(12):
        s1 = m1.train_one_iteration(s1, jax.random.fold_in(
            jax.random.PRNGKey(2), i))
    r1 = ev.evaluate(m1, s1, test, train)

    m2 = CDAE(cfg)
    s2 = m2.reset(train, seed=2)
    s2 = m2.train_epochs(s2, 12, jax.random.PRNGKey(2))
    r2 = Evaluation.create("TOPN").evaluate(m2, s2, test, train)
    assert s2.step == 12
    # same quality band (different RNG streams -> not bitwise)
    assert abs(r1["R@10"] - r2["R@10"]) < 0.25
    assert r2["R@10"] > 0.2


def test_row_update_matches_dense_apply_sgd(data):
    """CDAEConfig.row_update (touched-rows delta AdaGrad — the huge-catalog
    apply) is algebraically the SAME update as the dense accumulate-then-
    apply when using_adagrad=False (plain SGD is linear in the per-touch
    contributions), so the two paths must match to float tolerance on one
    step — across the tied/pooled/asymmetric/gated config families."""
    import jax.numpy as jnp
    from cdae_jax.models import cdae as M

    rng = np.random.default_rng(0)
    B, L, I, D = 8, 12, 40, 6
    items = np.sort(rng.integers(0, I, size=(B, L)).astype(np.int32), axis=1)
    mask = rng.random((B, L)) < 0.8
    items = np.sort(np.where(mask, items, I).astype(np.int32), axis=1)
    mask = items < I
    lengths = mask.sum(1).astype(np.int32)
    uids = np.arange(B, dtype=np.int32)
    weight = np.ones(B, np.float32)
    weight[-1] = 0.0  # padding row must stay inert in both paths
    u_all = np.repeat(np.arange(B), lengths)
    i_all = np.concatenate([items[b, : lengths[b]] for b in range(B)])
    ds = Interactions.from_arrays(u_all.astype(np.int32),
                                  i_all.astype(np.int32),
                                  num_users=B, num_items=I)
    for kw in ({}, {"neg_pool": 16}, {"asymmetric": True},
               {"linear_function": True}):
        base = dict(num_dim=D, loss="SQUARE", using_adagrad=False, **kw)
        model = M.CDAE(M.CDAEConfig(row_update=False, **base))
        params0 = M.CDAE(M.CDAEConfig(row_update=False, **base)).reset(
            ds, seed=1).params
        key = jax.random.PRNGKey(7)
        outs = []
        for row in (False, True):
            cfg = M.CDAEConfig(row_update=row, **base)
            outs.append(M._train_step(
                {k: jnp.array(v) for k, v in params0.items()},
                jnp.asarray(uids), jnp.asarray(items), jnp.asarray(mask),
                jnp.asarray(lengths), jnp.asarray(weight), key,
                cfg=cfg, loss=model.loss))
        for k in outs[0]:
            np.testing.assert_allclose(
                np.asarray(outs[0][k]), np.asarray(outs[1][k]),
                atol=2e-5, rtol=1e-5, err_msg=f"{kw} {k}")


def test_row_update_adagrad_learns(data):
    """row_update=True with AdaGrad (the config-5 path) trains to a
    recall in the sparse path's ballpark."""
    train, test = data.split_by_user(0.2, seed=20141119)
    model = CDAE(CDAEConfig(num_dim=8, loss="SQUARE", corruption_ratio=0.2,
                            scaled=True, batch_size=16, row_update=True, neg_pool=16))
    solver = Solver(model, max_iteration=8, eval_iterations=8,
                    seed=3, verbose=False)
    solver.train(train, test, ["TOPN"])
    assert solver.history[-1]["R@10"] > solver.history[0]["R@10"]


def test_iter_user_batches_csr_slots_budget():
    """Token-budget mode: every user appears exactly once, live B*L stays
    within the budget (down to the min batch of 8), and each user's row
    content matches the fixed-size iterator's."""
    import numpy as np

    from cdae_jax.data.dataset import Interactions
    from cdae_jax.models.base import iter_user_batches_csr

    rng = np.random.default_rng(7)
    U, I = 400, 300
    # heavy-tailed degrees: a few users rate ~half the catalog
    degs = np.minimum(1 + rng.geometric(1 / 8.0, U), I - 1)
    degs[:5] = I // 2
    users = np.repeat(np.arange(U), degs)
    items = rng.integers(0, I, len(users))
    pairs = np.unique(users.astype(np.int64) * I + items)
    data = Interactions.from_arrays(
        (pairs // I).astype(np.int32), (pairs % I).astype(np.int32),
        np.ones(len(pairs), np.float32), num_users=U, num_items=I)
    csr = data.csr()
    slots = 512
    seen = {}
    for b in iter_user_batches_csr(csr, I, batch_size=64,
                                   slots_per_batch=slots):
        B, L = b.items.shape
        live = int(b.weight.sum())
        assert B * L <= max(slots, 8 * L), (B, L)
        for r in range(B):
            if b.weight[r] == 0:
                continue
            u = int(b.uids[r])
            assert u not in seen
            seen[u] = set(b.items[r][b.mask[r]].tolist())
    assert len(seen) == U
    # content parity vs the fixed-size iterator
    ref = {}
    for b in iter_user_batches_csr(csr, I, batch_size=64):
        B, L = b.items.shape
        for r in range(B):
            if b.weight[r] == 0:
                continue
            ref[int(b.uids[r])] = set(b.items[r][b.mask[r]].tolist())
    assert seen == ref


def test_cdae_packed_io_matches_unpacked():
    """packed_io (lane-packed [W|b'] gathers + combined-grad scatters) must
    produce the same training trajectory as the unpacked path up to f32
    summation-order rounding: near-identical params after several sparse
    steps and identical recall after short training."""
    import numpy as np

    from cdae_jax.data.dataset import Interactions, movielens_line_parser
    from cdae_jax.models.cdae import CDAE, CDAEConfig
    from cdae_jax.solver.solver import Solver

    import os
    path = os.path.join(os.path.dirname(__file__), "data",
                        "sample_movielens.txt")
    data = Interactions.from_text(path, movielens_line_parser)
    train, test = data.split_by_user(0.2, seed=20141119)

    res = {}
    params = {}
    for packed in (False, True):
        for pool in (None, 16):
            model = CDAE(CDAEConfig(
                num_dim=8, loss="SQUARE", corruption_ratio=0.5, scaled=True,
                num_neg=3, user_factor=True, batch_size=16,
                packed_io=packed, neg_pool=pool,
                cache_device_batches=False,
            ))
            solver = Solver(model, max_iteration=6, eval_iterations=6,
                            seed=5, verbose=False)
            solver.train(train, test, ["TOPN"])
            res[(packed, pool)] = solver.history[-1]["R@10"]
            params[(packed, pool)] = np.asarray(
                solver.state.params["W"])
    for pool in (None, 16):
        np.testing.assert_allclose(params[(True, pool)],
                                   params[(False, pool)],
                                   rtol=2e-3, atol=2e-5)
        assert abs(res[(True, pool)] - res[(False, pool)]) < 0.02, res
