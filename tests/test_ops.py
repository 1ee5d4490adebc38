"""Ops-layer tests: losses vs autodiff & reference formulas, sampling,
corruption stats, top-k vs argsort, metrics vs a straightforward host loop."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cdae_jax.ops import corruption, metrics, sampling, topk
from cdae_jax.ops.losses import Loss, LossType
from cdae_jax.ops.penalties import Penalty, PenaltyType


# ---------------------------------------------------------------- losses ----

def ref_loss_eval(name, pred, truth):
    """Scalar reference-math implementations (ref src/model/loss.hpp)."""
    if name == "SQUARE":
        return (truth - pred) ** 2
    if name == "LOGISTIC":
        return -math.log(max(1e-4, pred if truth == 1.0 else 1.0 - pred))
    if name == "CROSS_ENTROPY":
        ret = (1 - truth) * pred
        if pred > 18:
            return ret + math.exp(-pred)
        if pred < -18:
            return ret - pred
        return ret + math.log1p(math.exp(-pred))
    if name in ("LOG", "LOGM", "HINGE", "SQUARED_HINGE"):
        z = pred * truth if name != "LOGM" else pred
        if name == "LOG":
            if z > 18: return math.exp(-z)
            if z < -18: return -z
            return math.log1p(math.exp(-z))
        if name == "LOGM":
            if z > 18: return truth * math.exp(-z)
            if z < -18: return -z * truth
            return truth * math.log1p(math.exp(-pred))
        if name == "HINGE":
            return max(0.0, 1.0 - pred * truth)
        d = max(0.0, 1.0 - pred * truth)
        return 0.5 * d * d
    raise ValueError(name)


LOSS_CASES = [
    ("SQUARE", [0.3, -2.0, 20.0], [1.0, 0.0]),
    ("LOGISTIC", [0.2, 0.5, 0.99], [1.0, 0.0]),
    ("CROSS_ENTROPY", [-25.0, -3.0, 0.0, 3.0, 25.0], [1.0, 0.0]),
    ("LOG", [-25.0, -3.0, 0.5, 3.0, 25.0], [1.0, -1.0]),
    ("LOGM", [-25.0, -3.0, 0.5, 3.0, 25.0], [1.0, -1.0]),
    ("HINGE", [-2.0, 0.5, 2.0], [1.0, -1.0]),
    ("SQUARED_HINGE", [-2.0, 0.5, 2.0], [1.0, -1.0]),
]


@pytest.mark.parametrize("name,preds,truths", LOSS_CASES)
def test_loss_eval_matches_reference_math(name, preds, truths):
    loss = Loss.create(name)
    for p in preds:
        for t in truths:
            got = float(loss.evaluate(jnp.float32(p), jnp.float32(t)))
            want = ref_loss_eval(name, p, t)
            # f32 exp/log + cancellation (e.g. CE at pred=-3) costs ~1e-4 abs
            assert got == pytest.approx(want, rel=1e-4, abs=2e-4), (name, p, t)


@pytest.mark.parametrize("name,preds,truths", LOSS_CASES)
def test_loss_gradient_matches_autodiff(name, preds, truths):
    loss = Loss.create(name)
    g = jax.grad(lambda p, t: loss.evaluate(p, t).sum())
    for p in preds:
        for t in truths:
            if name == "LOGISTIC" and not (1e-6 < p < 1 - 1e-6):
                continue
            # skip saturated/kink regions where the clamped eval is flat
            if name in ("CROSS_ENTROPY",) and abs(p) > 18:
                continue
            if name in ("LOG",) and abs(p * t) > 18:
                continue
            if name == "LOGM" and abs(p) > 18:
                continue
            if name in ("HINGE", "SQUARED_HINGE") and abs(p * t - 1.0) < 1e-3:
                continue
            if name == "LOGISTIC" and t == 0.0 and p > 1 - 1e-4:
                continue  # eval floor kicks in; gradient formula differs
            got = float(loss.gradient(jnp.float32(p), jnp.float32(t)))
            want = float(g(jnp.float32(p), jnp.float32(t)))
            assert got == pytest.approx(want, rel=2e-4, abs=1e-5), (name, p, t)


def test_loss_label_conventions():
    for name, neg in [("SQUARE", 0.0), ("LOGISTIC", 0.0), ("CROSS_ENTROPY", 0.0),
                      ("LOG", -1.0), ("LOGM", -1.0), ("HINGE", -1.0),
                      ("SQUARED_HINGE", -1.0)]:
        l = Loss.create(name)
        assert l.positive_label == 1.0
        assert l.negative_label == neg


def test_penalties():
    m = jnp.array([[1.0, -2.0], [3.0, 0.0]])
    assert float(Penalty.create("L2").evaluate(m)) == pytest.approx(14.0)
    assert float(Penalty.create("L1").evaluate(m)) == pytest.approx(6.0)
    assert Penalty.create(PenaltyType.L2).is_smooth
    assert not Penalty.create(PenaltyType.L1).is_smooth


# -------------------------------------------------------------- sampling ----

def test_sample_unrated_never_hits_rated():
    num_items = 50
    rated = np.array([
        [1, 3, 7, 49, num_items, num_items],
        [0, 1, 2, 3, 4, 5],
        [num_items] * 6,  # user with no interactions
    ], dtype=np.int32)
    lengths = np.array([4, 6, 0], dtype=np.int32)
    key = jax.random.PRNGKey(0)
    out = np.asarray(sampling.sample_unrated(
        key, jnp.asarray(rated), jnp.asarray(lengths), num_items, 2000
    ))
    assert out.min() >= 0 and out.max() < num_items
    for b in range(3):
        rated_set = set(rated[b, : lengths[b]].tolist())
        assert not (set(out[b].tolist()) & rated_set)


def test_sample_unrated_uniform_over_complement():
    num_items = 10
    rated = np.array([[2, 5, 8, num_items]], dtype=np.int32)
    lengths = np.array([3], dtype=np.int32)
    out = np.asarray(sampling.sample_unrated(
        jax.random.PRNGKey(1), jnp.asarray(rated), jnp.asarray(lengths),
        num_items, 70_000,
    ))[0]
    counts = np.bincount(out, minlength=num_items)
    assert counts[[2, 5, 8]].sum() == 0
    complement = [0, 1, 3, 4, 6, 7, 9]
    freq = counts[complement] / counts.sum()
    assert np.abs(freq - 1 / 7).max() < 0.01


# ------------------------------------------------------------ corruption ----

def test_corrupt_mask_rate():
    mask = jnp.ones((200, 100), dtype=bool)
    kept = corruption.corrupt_mask(jax.random.PRNGKey(2), mask, 0.5)
    rate = float(jnp.mean(kept.astype(jnp.float32)))
    assert abs(rate - 0.5) < 0.02
    # ratio 0 keeps everything; padding stays masked
    mask2 = mask.at[:, 50:].set(False)
    kept2 = corruption.corrupt_mask(jax.random.PRNGKey(3), mask2, 0.0)
    assert bool(jnp.all(kept2 == mask2))
    assert corruption.input_scale(0.5, True) == pytest.approx(2.0)
    assert corruption.input_scale(0.5, False) == 1.0
    assert corruption.input_scale(1.0, True) == 1.0


# ------------------------------------------------------------------ topk ----

def test_topk_unrated_matches_argsort():
    rng = np.random.default_rng(0)
    B, I, L, K = 4, 37, 5, 10
    scores = rng.normal(size=(B, I)).astype(np.float32)
    rated = np.full((B, L), I, dtype=np.int32)
    for b in range(B):
        n = rng.integers(0, L + 1)
        rated[b, :n] = np.sort(rng.choice(I, size=n, replace=False))
    ids, vals = topk.topk_unrated(jnp.asarray(scores), jnp.asarray(rated), K)
    ids = np.asarray(ids)
    for b in range(B):
        rated_set = set(rated[b][rated[b] < I].tolist())
        order = [i for i in np.argsort(-scores[b], kind="stable")
                 if i not in rated_set][:K]
        assert ids[b].tolist() == order


# --------------------------------------------------------------- metrics ----

def host_topn_eval(rec_list, val_map):
    """Direct port of the reference evaluate_rec_list loop semantics
    (ref src/model/evaluation.hpp:183-218) as plain Python."""
    rets = [0.0] * 8
    hit = 0.0
    map5 = map10 = 0.0
    for idx in range(min(20, len(rec_list))):
        if rec_list[idx] in val_map:
            hit += 1.0
            if idx < 5:
                map5 += hit / (idx + 1)
            if idx < 10:
                map10 += hit / (idx + 1)
        if idx == 0:
            rets[0] = hit / 1.0
            rets[3] = hit / len(val_map)
        elif idx == 4:
            rets[1] = hit / 5.0
            rets[4] = hit / len(val_map)
        elif idx == 9:
            rets[2] = hit / 10.0
            rets[5] = hit / len(val_map)
    rets[6] = map5 / min(5, len(val_map))
    rets[7] = map10 / min(10, len(val_map))
    return rets


def test_topn_metrics_match_reference_loop():
    rng = np.random.default_rng(3)
    B, I, Lv = 6, 40, 7
    rec = np.stack([rng.choice(I, size=10, replace=False) for _ in range(B)])
    val_items = np.full((B, Lv), I, dtype=np.int32)
    val_mask = np.zeros((B, Lv), dtype=bool)
    for b in range(B):
        n = rng.integers(1, Lv + 1)
        val_items[b, :n] = rng.choice(I, size=n, replace=False)
        val_mask[b, :n] = True
    rows = np.asarray(metrics.topn_user_metrics(
        jnp.asarray(rec, dtype=jnp.int32), jnp.asarray(val_items),
        jnp.asarray(val_mask),
    ))
    for b in range(B):
        vm = {int(i): 1.0 for i in val_items[b][val_mask[b]]}
        want = host_topn_eval(rec[b].tolist(), vm)
        np.testing.assert_allclose(rows[b], want, rtol=1e-5, atol=1e-6)


def host_ranking_eval(rec_list, val_map):
    """Port of the RANKING evaluate_rec_list (ref evaluation.hpp:309-361)."""
    rets = [0.0] * 8
    gt = sorted(val_map.items(), key=lambda kv: -kv[1])
    DCG5 = DCG10 = IDCG5 = IDCG10 = 0.0
    hit5 = hit10 = map5 = map10 = 0.0
    for idx in range(10):
        if idx < len(val_map):
            if idx < 5:
                IDCG5 += (2 ** gt[idx][1] - 1.0) / math.log(idx + 2.0)
            IDCG10 += (2 ** gt[idx][1] - 1.0) / math.log(idx + 2.0)
        iid = rec_list[idx]
        if iid in val_map:
            if idx < 5:
                DCG5 += (2 ** val_map[iid] - 1.0) / math.log(idx + 2.0)
            DCG10 += (2 ** val_map[iid] - 1.0) / math.log(idx + 2.0)
            if val_map[iid] >= 4.0:
                if idx < 5:
                    hit5 += 1.0
                    map5 += hit5 / (idx + 1.0)
                hit10 += 1.0
                map10 += hit10 / (idx + 1.0)
    rets[0] = DCG5 / IDCG5 if IDCG5 else 0.0
    rets[1] = DCG10 / IDCG10 if IDCG10 else 0.0
    rets[2] = hit5 / 5.0
    rets[3] = hit10 / 10.0
    num_rels = sum(1 for v in val_map.values() if v >= 4.0)
    if num_rels > 0:
        rets[4] = hit5 / num_rels
        rets[5] = hit10 / num_rels
        rets[6] = map5 / min(5.0, len(val_map))
        rets[7] = map10 / min(10.0, len(val_map))
    return rets


def test_ranking_metrics_match_reference_loop():
    rng = np.random.default_rng(4)
    B, I, Lv = 6, 40, 8
    rec = np.stack([rng.choice(I, size=10, replace=False) for _ in range(B)])
    val_items = np.full((B, Lv), I, dtype=np.int32)
    val_ratings = np.zeros((B, Lv), dtype=np.float32)
    val_mask = np.zeros((B, Lv), dtype=bool)
    for b in range(B):
        n = rng.integers(1, Lv + 1)
        val_items[b, :n] = rng.choice(I, size=n, replace=False)
        val_ratings[b, :n] = rng.integers(1, 6, size=n)
        val_mask[b, :n] = True
    rows = np.asarray(metrics.ranking_user_metrics(
        jnp.asarray(rec, dtype=jnp.int32), jnp.asarray(val_items),
        jnp.asarray(val_ratings), jnp.asarray(val_mask),
    ))
    for b in range(B):
        vm = {int(i): float(r) for i, r, m in
              zip(val_items[b], val_ratings[b], val_mask[b]) if m}
        want = host_ranking_eval(rec[b].tolist(), vm)
        np.testing.assert_allclose(rows[b], want, rtol=1e-4, atol=1e-5)


def test_ranking_rel_threshold_knob():
    """rel_threshold (a build knob; the reference hardcodes >=4) moves
    the hit cut: relevance-3 items count at threshold 3, not at 4."""
    rec = jnp.asarray([[0, 1, 2, 3, 4, 5, 6, 7, 8, 9]], dtype=jnp.int32)
    val_items = jnp.asarray([[0, 1, 2]], dtype=jnp.int32)
    val_ratings = jnp.asarray([[3.0, 3.0, 3.0]])
    val_mask = jnp.ones((1, 3), dtype=bool)
    at4 = np.asarray(metrics.ranking_user_metrics(
        rec, val_items, val_ratings, val_mask))
    at3 = np.asarray(metrics.ranking_user_metrics(
        rec, val_items, val_ratings, val_mask, rel_threshold=3.0))
    i_p10 = metrics.RANKING_COLUMNS.index("Prec@10")
    assert at4[0, i_p10] == 0.0
    assert at3[0, i_p10] == pytest.approx(0.3)
    # NDCG ignores the threshold (gain = 2^rel - 1 regardless)
    i_ndcg = metrics.RANKING_COLUMNS.index("NDCG@10")
    assert at4[0, i_ndcg] == pytest.approx(at3[0, i_ndcg])


def test_rmse_mae():
    p = jnp.array([1.0, 2.0, 3.0])
    l = jnp.array([1.0, 1.0, 5.0])
    assert float(metrics.rmse(p, l)) == pytest.approx(math.sqrt(5 / 3))
    assert float(metrics.mae(p, l)) == pytest.approx(1.0)


def test_sample_unrated_full_catalog_sentinel():
    """A user who rated the WHOLE catalog gets the sentinel id num_items
    back (empty complement) — consumers must zero-weight, never clip."""
    import jax

    I = 8
    items = jnp.asarray([[0, 1, 2, 3, 4, 5, 6, 7]], dtype=jnp.int32)
    lengths = jnp.asarray([I], dtype=jnp.int32)
    out = sampling.sample_unrated(jax.random.PRNGKey(0), items, lengths, I, 5)
    assert (np.asarray(out) == I).all()


def test_full_catalog_user_trains_safely():
    """Models must not push gradients through sentinel negatives (the
    clip-to-I-1 bug turned a rated item into a live negative)."""
    import jax
    from cdae_jax.data.dataset import Interactions
    from cdae_jax.models.cdae import CDAE, CDAEConfig
    from cdae_jax.models.mf import BPR, IMF, MFConfig

    # user 0 rated EVERY item; user 1 rated one
    users = np.array([0] * 6 + [1], dtype=np.int32)
    items = np.array([0, 1, 2, 3, 4, 5, 2], dtype=np.int32)
    data = Interactions.from_arrays(users, items, num_users=2, num_items=6)

    m = CDAE(CDAEConfig(num_dim=4, loss="SQUARE", num_neg=3, batch_size=2, dense_mode=False))
    s = m.reset(data, seed=0)
    s = m.train_one_iteration(s, jax.random.PRNGKey(0))
    assert np.isfinite(np.asarray(s.params["W"])).all()

    for cls in (IMF, BPR):
        mm = cls(MFConfig(num_dim=4, num_neg=3, batch_size=4,
                          dense_mode=False))
        st = mm.reset(data, seed=0)
        st = mm.train_one_iteration(st, jax.random.PRNGKey(0))
        assert np.isfinite(np.asarray(st.params["iv"])).all()


def test_matmul_scatter_add_matches_numpy():
    """MXU scatter (ops/scatter.py) == np.add.at, incl. the id==num_rows
    dead-slot sentinel and 1-D values."""
    import jax.numpy as jnp

    from cdae_jax.ops.scatter import matmul_scatter_add, scatter_add_rows

    rng = np.random.default_rng(7)
    P, N, D = 257, 53, 11
    idx = rng.integers(0, N + 1, size=P)  # N == dead slot
    vals = rng.standard_normal((P, D)).astype(np.float32)
    ref = np.zeros((N, D), np.float32)
    live = idx < N
    np.add.at(ref, idx[live], vals[live])

    out = matmul_scatter_add(jnp.asarray(idx, jnp.int32), jnp.asarray(vals), N)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-6, atol=1e-6)

    base = rng.standard_normal((N, D)).astype(np.float32)
    for mode in ("auto", "matmul", "scatter"):
        out2 = scatter_add_rows(
            jnp.asarray(base), jnp.asarray(idx[live], jnp.int32),
            jnp.asarray(vals[live]), mode=mode,
        )
        np.testing.assert_allclose(np.asarray(out2), base + ref,
                                   rtol=1e-5, atol=1e-5)

    # 1-D values
    v1 = rng.standard_normal(P).astype(np.float32)
    ref1 = np.zeros((N,), np.float32)
    np.add.at(ref1, idx[live], v1[live])
    out1 = matmul_scatter_add(jnp.asarray(idx, jnp.int32), jnp.asarray(v1), N)
    np.testing.assert_allclose(np.asarray(out1), ref1, rtol=1e-6, atol=1e-6)


def test_rank_select_first_gt_matches_naive():
    """Batched bisection (models/mf._rank_select_first_gt) == the one-shot
    count formula Σ_i (cum_i <= v) on monotone rows, incl. the none-found
    (j == I) case WARP zero-weights."""
    import jax.numpy as jnp

    from cdae_jax.models.mf import _rank_select_first_gt

    rng = np.random.default_rng(5)
    B, I, K = 7, 53, 4
    flags = rng.integers(0, 2, size=(B, I))
    cum = np.cumsum(flags, axis=1).astype(np.int32)
    v = rng.integers(0, np.maximum(cum[:, -1:], 1), size=(B, K)).astype(
        np.int32
    )
    v[0, 0] = cum[0, -1]  # none-found: cum never exceeds -> I
    got = np.asarray(_rank_select_first_gt(jnp.asarray(cum), jnp.asarray(v)))
    want = np.sum(cum[:, :, None] <= v[:, None, :], axis=1)
    np.testing.assert_array_equal(got, want)


def test_factored_scatter_add_matches_numpy():
    """Two-level one-hot aggregation == np.add.at for every C decomposition,
    incl. the sentinel (id == num_rows) and a non-divisible num_rows."""
    import jax.numpy as jnp

    from cdae_jax.ops.scatter import factored_matmul_scatter_add

    rng = np.random.default_rng(11)
    P, N, D = 513, 101, 7  # N not a multiple of any C
    idx = rng.integers(0, N + 1, size=P)  # N == dead slot
    vals = rng.standard_normal((P, D)).astype(np.float32)
    ref = np.zeros((N, D), np.float32)
    live = idx < N
    np.add.at(ref, idx[live], vals[live])

    for c in (0, 8, 16, 101, 128):  # 0 = auto-pick
        out = factored_matmul_scatter_add(
            jnp.asarray(idx, jnp.int32), jnp.asarray(vals), N, c=c
        )
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5,
                                   atol=1e-5, err_msg=f"c={c}")

    # 1-D values + bf16 operand mode stays within rounding tolerance
    v1 = rng.standard_normal(P).astype(np.float32)
    ref1 = np.zeros((N,), np.float32)
    np.add.at(ref1, idx[live], v1[live])
    out1 = factored_matmul_scatter_add(jnp.asarray(idx, jnp.int32),
                                       jnp.asarray(v1), N)
    np.testing.assert_allclose(np.asarray(out1), ref1, rtol=1e-5, atol=1e-5)
    out_bf = factored_matmul_scatter_add(
        jnp.asarray(idx, jnp.int32), jnp.asarray(vals), N,
        vals_dtype=jnp.bfloat16,
    )
    np.testing.assert_allclose(np.asarray(out_bf), ref, rtol=0.05, atol=0.05)


def test_resolve_auto_mode_flop_guard():
    """'auto' stays on the one-hot matmul while 2·P·N·D is in budget, and
    falls back to the catalog-size-independent sort/segment aggregation
    beyond it (huge-catalog pairwise: N=1M at P=24k, D=11 must NOT pick the
    dot — ~0.5 TFLOP per step)."""
    from cdae_jax.ops.scatter import _MATMUL_FLOP_LIMIT, resolve_auto_mode

    # bench shapes (ML-1M: P=24k rows into N=3706) stay on the matmul
    assert resolve_auto_mode(24_576, 3_706, 11) == "matmul"
    # huge catalogs cross the FLOP budget -> sort
    assert resolve_auto_mode(24_576, 1_000_000, 11) == "sort"
    # boundary: exactly at the limit stays matmul
    P = int(_MATMUL_FLOP_LIMIT // (2.0 * 1000 * 10))
    assert resolve_auto_mode(P, 1000, 10) == "matmul"
    assert resolve_auto_mode(P + 1, 1000, 10) == "sort"


@pytest.mark.parametrize("mode", ["factored", "factored_bf16", "matmul",
                                  "sort", "scatter"])
def test_scatter_add_rows_matches_add_at(mode):
    """Every strategy of the dispatcher equals np.add.at, duplicates and
    out-of-range sentinel ids included (the sentinel adds nothing)."""
    import jax.numpy as jnp

    from cdae_jax.ops.scatter import scatter_add_rows

    rng = np.random.default_rng(5)
    N, P, D = 37, 300, 6
    idx = rng.integers(0, N, P).astype(np.int32)
    idx[:20] = 3  # a hot row
    idx[-5:] = N  # sentinel slots
    vals = rng.standard_normal((P, D)).astype(np.float32)
    base = rng.standard_normal((N, D)).astype(np.float32)
    ref = base.copy()
    live = idx < N
    np.add.at(ref, idx[live], vals[live])
    got = scatter_add_rows(jnp.asarray(base), jnp.asarray(idx),
                           jnp.asarray(vals), mode=mode)
    tol = 3e-2 if mode == "factored_bf16" else 1e-4
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol, atol=tol)


def test_scatter_add_rows_rejects_unknown_mode():
    import jax.numpy as jnp
    import pytest

    from cdae_jax.ops.scatter import scatter_add_rows

    with pytest.raises(ValueError):
        scatter_add_rows(jnp.zeros((4, 2)), jnp.zeros((3,), jnp.int32),
                         jnp.ones((3, 2)), mode="bogus")


def test_is_rated_matches_naive_membership():
    """ops/sampling.is_rated: CSR-gathered membership == naive set lookup
    (both shared (Q,) and per-row (B, Q) query layouts, Q above and below
    the 32-wide chunk)."""
    rng = np.random.default_rng(7)
    num_items = 200
    B, L = 5, 12
    rated = np.full((B, L), num_items, np.int32)
    lengths = rng.integers(0, L, size=B).astype(np.int32)
    for b in range(B):
        rated[b, : lengths[b]] = np.sort(
            rng.choice(num_items, size=lengths[b], replace=False)
        )
    for Q in (8, 100):
        q_shared = rng.integers(0, num_items, size=Q).astype(np.int32)
        got = np.asarray(sampling.is_rated(
            jnp.asarray(rated), jnp.asarray(lengths), jnp.asarray(q_shared)
        ))
        for b in range(B):
            rated_set = set(rated[b, : lengths[b]].tolist())
            want = np.array([x in rated_set for x in q_shared])
            assert np.array_equal(got[b], want)
        q_rows = rng.integers(0, num_items, size=(B, Q)).astype(np.int32)
        got = np.asarray(sampling.is_rated(
            jnp.asarray(rated), jnp.asarray(lengths), jnp.asarray(q_rows)
        ))
        for b in range(B):
            rated_set = set(rated[b, : lengths[b]].tolist())
            want = np.array([x in rated_set for x in q_rows[b]])
            assert np.array_equal(got[b], want)


def test_row_adagrad_delta_sequential_duplicates():
    """Duplicate row ids within one call must see SEQUENTIAL accumulator
    semantics (each touch includes the earlier touches' g²) — the
    reference's per-touch loop (cdae.hpp:230-257). The old scheme gave
    every duplicate the pre-call accumulator: a hot item touched t times
    took t near-full steps against the 1e-4 init (−0.11 recall on the
    row_update parity cell, round 5)."""
    import numpy as np

    from cdae_jax.solver.optimizer import ADAGRAD_INIT, row_adagrad_delta

    rng = np.random.default_rng(0)
    N, D = 7, 3
    rows = np.array([2, 5, 2, 2, 6, 5, 1, 0], np.int32)
    grads = rng.standard_normal((len(rows), D)).astype(np.float32)
    live = np.ones((len(rows), D), bool)
    live[7] = False  # dead contribution must not move anything
    p0 = rng.standard_normal((N, D)).astype(np.float32)
    a0 = np.full((N, D), ADAGRAD_INIT, np.float32)
    lr, beta = 0.1, 0.5

    p, a = row_adagrad_delta(
        jnp.asarray(p0), jnp.asarray(a0), jnp.asarray(rows),
        jnp.asarray(grads), jnp.asarray(live), lr, beta, True)

    # python sequential reference: touches applied in list order
    pe, ae = p0.copy(), a0.copy()
    for i, r in enumerate(rows):
        if not live[i].any():
            continue
        g = grads[i]
        ae[r] += g * g
        pe[r] -= lr * g / (beta + np.sqrt(ae[r]))
    np.testing.assert_allclose(np.asarray(a), ae, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p), pe, rtol=1e-5, atol=1e-6)
