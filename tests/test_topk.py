"""Blockwise streaming top-k (ops/topk.streaming_topk_scores) against the
dense masked top-k (ops/topk.topk_unrated), and CDAE.batch_topk's
streaming route."""

import jax.numpy as jnp
import numpy as np
import pytest

from cdae_jax.ops.topk import streaming_topk_scores, topk_unrated


@pytest.fixture(scope="module")
def rng_np():
    return np.random.default_rng(11)


def _check_against_dense(z, W, bp, rated, k, block):
    """Streaming ids/vals equal the dense reference's wherever an unrated
    item exists; slots with none left are the sentinel I at -inf."""
    I = W.shape[0]
    scores = z @ W.T + bp[None, :]
    ids_ref, vals_ref = topk_unrated(scores, rated, k)
    ids, vals = streaming_topk_scores(z, W, bp, rated, k=k, block=block)
    ids, vals = np.asarray(ids), np.asarray(vals)
    ids_ref, vals_ref = np.asarray(ids_ref), np.asarray(vals_ref)
    np.testing.assert_allclose(vals, vals_ref, rtol=1e-5, atol=1e-5)
    live = np.isfinite(vals_ref)
    np.testing.assert_array_equal(ids[live], ids_ref[live])
    assert (ids[~live] == I).all()
    return ids, vals


def _rated_rows(rng, B, I, L, n_min=1):
    rated = np.full((B, L), I, np.int32)
    for b in range(B):
        n = int(rng.integers(n_min, L + 1))
        rated[b, :n] = np.sort(rng.choice(I, n, replace=False))
    return rated


def test_streaming_topk_matches_dense(rng_np):
    B, D, I, L, K = 12, 16, 1000, 8, 10
    z = jnp.asarray(rng_np.standard_normal((B, D)).astype(np.float32))
    W = jnp.asarray(rng_np.standard_normal((I, D)).astype(np.float32))
    bp = jnp.asarray(rng_np.standard_normal(I).astype(np.float32))
    rated = np.sort(
        rng_np.choice(I, size=(B, L), replace=False), axis=1
    ).astype(np.int32)
    scores = z @ W.T + bp[None, :]
    ids_ref, vals_ref = topk_unrated(scores, jnp.asarray(rated), K)
    ids, vals = streaming_topk_scores(z, W, bp, jnp.asarray(rated),
                                      k=K, block=256)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(vals_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ids_ref))


# (B, D, I, L, K, block, case)
CASES = {
    "random": (8, 16, 300, 6, 10, 64, "random"),
    "fewer_unrated_than_k": (4, 8, 140, 140, 10, 64, "nearly_full"),
    "block_not_dividing_catalog": (8, 16, 1100, 9, 10, 128, "random"),
    "block_smaller_than_k": (5, 9, 90, 4, 10, 4, "random"),
    "batch_over_256": (300, 8, 400, 16, 10, 128, "random"),
    "clustered_rated_block": (6, 8, 400, 32, 10, 128, "clustered"),
    "sentinel_padding": (12, 16, 333, 24, 10, 128, "padded"),
    "tied_scores": (6, 4, 200, 5, 10, 64, "ties"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streaming_topk_cases(rng_np, case):
    B, D, I, L, K, block, kind = CASES[case]
    z = rng_np.standard_normal((B, D)).astype(np.float32)
    W = rng_np.standard_normal((I, D)).astype(np.float32)
    bp = rng_np.standard_normal(I).astype(np.float32)
    if kind == "nearly_full":
        rated = np.tile(np.arange(I, dtype=np.int32), (B, 1))
        rated[0, :5] = I  # 5 unrated < k
        rated[1, :] = I  # everything unrated
        rated = np.sort(rated, axis=1)  # rows 2-3: nothing unrated at all
    elif kind == "clustered":
        rated = _rated_rows(rng_np, B, I, 4)
        rated = np.pad(rated, ((0, 0), (0, L - 4)), constant_values=I)
        rated[0, :30] = np.arange(50, 80)  # 30 rated ids in one block
        rated[0, 30:] = I
    elif kind == "padded":
        rated = _rated_rows(rng_np, B, I, L)  # per-row lengths vary
    elif kind == "ties":
        # integer-valued scores with many exact ties across blocks
        z = rng_np.integers(-2, 3, (B, D)).astype(np.float32)
        W = rng_np.integers(-1, 2, (I, D)).astype(np.float32)
        bp = np.zeros(I, np.float32)
        rated = _rated_rows(rng_np, B, I, L, n_min=L)
    else:
        rated = _rated_rows(rng_np, B, I, L, n_min=L)
    ids, _ = _check_against_dense(jnp.asarray(z), jnp.asarray(W),
                                  jnp.asarray(bp), jnp.asarray(rated),
                                  K, block)
    for b in range(B):  # never a rated item
        assert not set(ids[b].tolist()) & set(rated[b][rated[b] < I].tolist())


@pytest.mark.parametrize("variant", [
    dict(), dict(asymmetric=True),
], ids=["tied", "asymmetric"])
def test_cdae_batch_topk_streaming_route(movielens_path, monkeypatch,
                                         variant):
    """Past the deferral threshold CDAE.batch_topk serves the streaming
    scan, and its ids equal the dense-scores top-10."""
    import jax

    import cdae_jax.models.cdae as cdae_mod
    from cdae_jax.data.dataset import Interactions, movielens_line_parser
    from cdae_jax.models.cdae import CDAE, CDAEConfig

    data = Interactions.from_text(movielens_path, movielens_line_parser)
    train, _ = data.split_by_user(0.2, seed=20141119)
    model = CDAE(CDAEConfig(num_dim=8, loss="SQUARE", batch_size=32,
                            dense_mode=False, **variant))
    state = model.reset(train, seed=1)
    state = model.train_one_iteration(state, jax.random.PRNGKey(0))
    pb = state.padded
    uids = np.arange(8)
    ri, rm = pb.items[uids], pb.mask[uids]
    assert model.batch_topk(state, uids, ri, rm) is None  # deferred
    monkeypatch.setattr(cdae_mod, "_TOPK_DEFER_CELLS", 0)
    scores = model.batch_scores(state, uids, ri, rm)
    ids_ref, vals_ref = topk_unrated(scores, jnp.asarray(ri), 10)
    ids = model.batch_topk(state, uids, ri, rm)
    live = np.isfinite(np.asarray(vals_ref))
    np.testing.assert_array_equal(np.asarray(ids)[live],
                                  np.asarray(ids_ref)[live])
