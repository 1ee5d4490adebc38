"""utils layer: host parallel primitives (serial-equivalence testing, the
reference's strategy in test/parallel_test.hpp), Random facade, timer,
config, line search."""

import os

import numpy as np
import pytest

from cdae_jax.solver.line_search import line_search
from cdae_jax.utils import parallel as P
from cdae_jax.utils import random as R
from cdae_jax.utils.timer import Timer, time_function


def test_parallel_for_matches_serial():
    n = 1000
    out_p = np.zeros(n)
    P.parallel_for(0, n, lambda i: out_p.__setitem__(i, i * i), num_threads=4)
    np.testing.assert_array_equal(out_p, np.arange(n) ** 2)


def test_dynamic_parallel_for_matches_serial():
    n = 500
    out = np.zeros(n)
    P.dynamic_parallel_for(0, n, lambda i: out.__setitem__(i, 2 * i),
                           num_threads=3)
    np.testing.assert_array_equal(out, 2 * np.arange(n))


def test_parallel_for_each():
    items = list(range(64))
    out = np.zeros(64)
    P.parallel_for_each(items, lambda x: out.__setitem__(x, x + 1))
    np.testing.assert_array_equal(out, np.arange(64) + 1)


def test_parallel_accumulate_matches_serial():
    got = P.parallel_accumulate(0, 10000, lambda i: float(i), num_threads=5)
    assert got == sum(range(10000))


def test_random_facade_deterministic():
    R.seed(42)
    a = R.uniform(size=5)
    R.seed(42)
    b = R.uniform(size=5)
    np.testing.assert_array_equal(a, b)
    R.seed(0)
    x = list(range(10))
    R.shuffle(x)
    assert sorted(x) == list(range(10))
    d = R.discrete([0.0, 1.0, 0.0], size=20)
    assert (np.asarray(d) == 1).all()
    v = R.uniform_int(3, 7, size=100)
    assert v.min() >= 3 and v.max() < 7


def test_timer_and_time_function():
    t = Timer()
    assert t.elapsed() >= 0.0
    out, dt = time_function(lambda: 41 + 1)
    assert out == 42 and dt >= 0.0


def test_line_search_quadratic():
    f = lambda x: float(np.sum((x - 3.0) ** 2))
    x = np.zeros(2)
    grad = 2 * (x - 3.0)
    step, f_new = line_search(f, x, -grad, grad, step0=1.0)
    assert f_new < f(x)
    assert 0 < step <= 1.0


@pytest.fixture
def restore_cache_dir():
    import jax

    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_dir_wins(tmp_path, monkeypatch, restore_cache_dir):
    """A set JAX_COMPILATION_CACHE_DIR is left to JAX: enable() reports it
    and sets no other directory."""
    import jax

    from cdae_jax.utils.compile_cache import cache_dir, enable

    d = str(tmp_path / "xla")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    before = jax.config.jax_compilation_cache_dir
    assert enable() == d == cache_dir()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_inside_checkout(monkeypatch,
                                               restore_cache_dir):
    """Without the env var the cache is <repo>/.jax_cache, a directory
    .gitignore lists."""
    import jax

    from cdae_jax.utils.compile_cache import enable

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = enable()
    assert d == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == d
    assert os.path.isdir(d)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_path_stable(tmp_path, monkeypatch):
    """The default path depends on nothing that changes between runs: not
    the cwd, HOME, TMPDIR or the process."""
    from cdae_jax.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.cache_dir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    assert compile_cache.cache_dir() == first
    assert not first.startswith(str(tmp_path))
