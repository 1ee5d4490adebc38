"""Native host runtime (csrc/cdae_host.cpp via ctypes) parity tests."""

import numpy as np
import pytest

from cdae_jax import _native
from cdae_jax.data.dataset import (
    Interactions, default_line_parser, movielens_line_parser,
)

pytestmark = pytest.mark.skipif(
    not _native.available(), reason="native library unavailable"
)


def test_native_matches_python_movielens(movielens_path):
    d_py = Interactions.from_text(movielens_path, movielens_line_parser,
                                  use_native=False)
    d_nat = Interactions.from_text(movielens_path, movielens_line_parser,
                                   use_native=True)
    np.testing.assert_array_equal(d_py.users, d_nat.users)
    np.testing.assert_array_equal(d_py.items, d_nat.items)
    np.testing.assert_array_equal(d_py.ratings, d_nat.ratings)
    assert d_py.user_vocab.to_list() == d_nat.user_vocab.to_list()
    assert d_py.item_vocab.to_list() == d_nat.item_vocab.to_list()


def test_native_default_format_implicit_label(tmp_path):
    p = tmp_path / "pairs.txt"
    p.write_text("u1 i1 5\nu2 i2\n\nu1 i2 3\n")
    d_py = Interactions.from_text(str(p), default_line_parser,
                                  use_native=False)
    d_nat = Interactions.from_text(str(p), default_line_parser,
                                   use_native=True)
    # reference parser maps every rating to 1 (yelp.cpp:60-66)
    assert (d_nat.ratings == 1.0).all()
    np.testing.assert_array_equal(d_py.users, d_nat.users)
    np.testing.assert_array_equal(d_py.items, d_nat.items)


def test_native_multithreaded_big_file(tmp_path):
    """>1MB file exercises the chunked multi-thread path; vocab ids must
    still be first-seen order (matching the sequential reference)."""
    rng = np.random.default_rng(7)
    n = 60_000
    users = rng.integers(0, 500, n)
    items = rng.integers(0, 800, n)
    lines = [f"u{u:05d}::m{i:05d}::{(u + i) % 5 + 1}::123" for u, i in
             zip(users, items)]
    p = tmp_path / "big.txt"
    p.write_text("\n".join(lines) + "\n")
    assert p.stat().st_size > (1 << 20)
    d_py = Interactions.from_text(str(p), movielens_line_parser,
                                  use_native=False)
    d_nat = Interactions.from_text(str(p), movielens_line_parser,
                                   use_native=True)
    np.testing.assert_array_equal(d_py.users, d_nat.users)
    np.testing.assert_array_equal(d_py.items, d_nat.items)
    np.testing.assert_array_equal(d_py.ratings, d_nat.ratings)
    assert d_py.user_vocab.to_list() == d_nat.user_vocab.to_list()
    assert d_py.item_vocab.to_list() == d_nat.item_vocab.to_list()


def test_native_csr_matches_numpy():
    rng = np.random.default_rng(3)
    n = 5000
    k = rng.integers(0, 40, n).astype(np.int32)
    v = rng.integers(0, 60, n).astype(np.int32)
    r = rng.random(n).astype(np.float32)
    indptr, indices, values = _native.build_csr(k, v, r, 40)
    order = np.lexsort((v, k))
    np.testing.assert_array_equal(indices, v[order])
    np.testing.assert_array_equal(values, r[order])
    np.testing.assert_array_equal(
        indptr[1:], np.cumsum(np.bincount(k, minlength=40))
    )
    assert indptr[0] == 0


def test_native_dynamic_parallel_for_covers_range_and_raises():
    """cdae_dynamic_parallel_for: every index visited exactly once across
    chunk pulls (atomic-counter scheduling), exceptions propagate, and the
    utils wrapper routes through it."""
    import numpy as np

    from cdae_jax import _native
    from cdae_jax.utils.parallel import dynamic_parallel_for

    if not _native.available():
        import pytest

        pytest.skip("native library unavailable")

    hits = np.zeros(10_000, np.int64)

    def chunk(lo, hi):
        hits[lo:hi] += 1  # numpy slice add releases the GIL

    assert _native.dynamic_parallel_for(0, 10_000, chunk, grain=97)
    assert (hits == 1).all()

    # empty and sub-grain ranges
    assert _native.dynamic_parallel_for(5, 5, chunk)
    assert _native.dynamic_parallel_for(0, 3, chunk, grain=1000)

    def boom(lo, hi):
        raise ValueError("chunk failure")

    import pytest

    with pytest.raises(ValueError, match="chunk failure"):
        _native.dynamic_parallel_for(0, 100, boom, grain=10)

    out = np.zeros(777, np.int64)
    dynamic_parallel_for(0, 777, lambda i: out.__setitem__(i, 1))
    assert out.sum() == 777
