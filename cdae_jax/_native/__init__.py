"""ctypes bindings for the native host runtime (csrc/cdae_host.cpp).

Auto-builds the shared library on first import if a compiler is present
(``make -C csrc``); every entry point has a NumPy fallback, so the package
works without a toolchain. Disable with CDAE_NO_NATIVE=1.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libcdae_host.so")
_CSRC = os.path.normpath(os.path.join(_HERE, "..", "..", "csrc"))


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("CDAE_NO_NATIVE"):
        return None
    if not os.path.exists(_SO) and os.path.exists(
        os.path.join(_CSRC, "cdae_host.cpp")
    ):
        try:
            subprocess.run(
                ["make", "-C", _CSRC, os.path.relpath(_SO, _CSRC)],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    if not os.path.exists(_SO):
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.cdae_loader_parse.restype = ctypes.c_void_p
    lib.cdae_loader_parse.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int]
    for fn in ("cdae_loader_num_rows", "cdae_loader_num_users",
               "cdae_loader_num_items"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.cdae_loader_copy.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    for fn in ("cdae_loader_user_token", "cdae_loader_item_token"):
        getattr(lib, fn).restype = ctypes.c_char_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.cdae_loader_free.argtypes = [ctypes.c_void_p]
    lib.cdae_build_csr.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    lib.cdae_dynamic_parallel_for.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        CHUNK_FN, ctypes.c_void_p, ctypes.c_int,
    ]
    _LIB = lib
    return _LIB


CHUNK_FN = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_void_p)


def dynamic_parallel_for(start: int, end: int, chunk_fn, grain: int = 1,
                         num_threads: int = 0) -> bool:
    """Native dynamic work-queue parallel_for (the reference ThreadPool's
    scheduling semantics, thread_pool-inl.hpp:5-58): C worker threads pull
    [lo, hi) chunks off an atomic counter — per-chunk cost skew balances
    dynamically. ``chunk_fn(lo, hi)`` is invoked from NATIVE threads: a
    Python callable re-acquires the GIL on entry, so real speedup needs the
    body to release it (numpy ops, IO); pure-Python bodies get dynamic
    scheduling but GIL-serialized execution (documented host limitation).
    Returns False if the native library is unavailable (caller falls back).
    """
    lib = _load()
    if lib is None:
        return False
    err: list = []

    @CHUNK_FN
    def _cb(lo, hi, _ctx):
        try:
            chunk_fn(int(lo), int(hi))
        except BaseException as e:  # noqa: BLE001 — never unwind into C
            err.append(e)

    lib.cdae_dynamic_parallel_for(start, end, max(int(grain), 1), _cb, None,
                                  num_threads)
    if err:
        raise err[0]
    return True


def available() -> bool:
    return _load() is not None


FORMATS = {"default": 0, "movielens": 1}


def parse_text(path: str, fmt: str = "default", num_threads: int = 0):
    """Parse a ratings text file natively.

    Returns (users, items, ratings, user_tokens, item_tokens) or None if the
    native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    h = lib.cdae_loader_parse(
        path.encode(), FORMATS[fmt], num_threads
    )
    if not h:
        raise IOError(f"native loader failed to open {path}")
    try:
        n = lib.cdae_loader_num_rows(h)
        nu = lib.cdae_loader_num_users(h)
        ni = lib.cdae_loader_num_items(h)
        users = np.empty(n, np.int32)
        items = np.empty(n, np.int32)
        ratings = np.empty(n, np.float32)
        lib.cdae_loader_copy(h, users, items, ratings)
        u_tok = [lib.cdae_loader_user_token(h, i).decode() for i in range(nu)]
        i_tok = [lib.cdae_loader_item_token(h, i).decode() for i in range(ni)]
    finally:
        lib.cdae_loader_free(h)
    return users, items, ratings, u_tok, i_tok


def build_csr(
    keys: np.ndarray, vals: np.ndarray, ratings: np.ndarray, num_keys: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Native counting-sort CSR build; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(keys)
    indptr = np.empty(num_keys + 1, np.int64)
    indices = np.empty(n, np.int32)
    values = np.empty(n, np.float32)
    lib.cdae_build_csr(
        np.ascontiguousarray(keys, np.int32),
        np.ascontiguousarray(vals, np.int32),
        np.ascontiguousarray(ratings, np.float32),
        n, num_keys, indptr, indices, values,
    )
    return indptr, indices, values
