"""Sparse user-item interaction datasets.

Batched equivalent of the reference's Data/Instance containers
(ref: src/base/data.hpp:50-181, src/base/instance.hpp:33-225). Instead of a
vector of per-instance feature groups, interactions are stored as flat
COO numpy arrays (users, items, ratings) plus shared dimension info, with
derived CSR and padded-dense views that feed jit-compiled device code.

Capability map to the reference:
  - Data::load(RECSYS, parser)        -> Interactions.from_text / from_arrays
  - FeatureGroupInfo::get_index       -> Vocab (vocab.py)
  - random_split_by_feature_group     -> Interactions.split_by_user
    (per-user leave-k%-out protocol, ref src/base/data-inl.hpp:231-272)
  - random_split                      -> Interactions.random_split
  - get_feature_pair_label_hashtable  -> Interactions.user_item_dict / csr views
    (ref src/base/data-inl.hpp:413-429)
  - get_feature_to_vec_hashtable      -> Interactions.csr / csr_by_item
  - shuffle_data                      -> Interactions.shuffled
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from cdae_jax.data.vocab import Vocab

LineParser = Callable[[str], Optional[Tuple[str, str, str]]]


def default_line_parser(line: str) -> Optional[Tuple[str, str, str]]:
    """`user item [rating]` whitespace-separated; implicit rating=1.

    Mirrors the reference app's parser which maps every line to label 1
    (ref: apps/yelp/yelp.cpp:60-66).
    """
    parts = line.split()
    if len(parts) < 2:
        return None
    return parts[0], parts[1], "1"


def movielens_line_parser(line: str) -> Optional[Tuple[str, str, str]]:
    """`user::item::rating::timestamp` (MovieLens format, ref test fixture)."""
    parts = line.split("::")
    if len(parts) < 3:
        return None
    return parts[0], parts[1], parts[2]


@dataclasses.dataclass
class CSR:
    """Per-key compressed row view: ``indices[indptr[k]:indptr[k+1]]``."""

    indptr: np.ndarray  # (num_keys + 1,) int64
    indices: np.ndarray  # (nnz,) int32
    values: np.ndarray  # (nnz,) float32

    def row(self, k: int) -> np.ndarray:
        return self.indices[self.indptr[k] : self.indptr[k + 1]]

    def row_values(self, k: int) -> np.ndarray:
        return self.values[self.indptr[k] : self.indptr[k + 1]]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)


@dataclasses.dataclass
class PaddedUserBatch:
    """Padded dense per-user interaction lists, ready for device transfer.

    items are sorted ascending per user and padded with ``num_items`` — the
    sentinel keeps per-row sorted order intact so exact complement
    (rejection-free) negative sampling can use searchsorted on device.
    """

    uids: np.ndarray  # (U,) int32
    items: np.ndarray  # (U, L) int32, padded with num_items
    ratings: np.ndarray  # (U, L) float32, 0 at padding
    mask: np.ndarray  # (U, L) bool
    lengths: np.ndarray  # (U,) int32
    num_items: int

    @property
    def num_users(self) -> int:
        return self.uids.shape[0]

    @property
    def max_len(self) -> int:
        return self.items.shape[1]


class Interactions:
    """A user-item interaction dataset (COO layout + shared dims)."""

    def __init__(
        self,
        users: np.ndarray,
        items: np.ndarray,
        ratings: np.ndarray,
        num_users: int,
        num_items: int,
        user_vocab: Optional[Vocab] = None,
        item_vocab: Optional[Vocab] = None,
    ):
        self.users = np.asarray(users, dtype=np.int32)
        self.items = np.asarray(items, dtype=np.int32)
        self.ratings = np.asarray(ratings, dtype=np.float32)
        if not (len(self.users) == len(self.items) == len(self.ratings)):
            raise ValueError("users/items/ratings length mismatch")
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.user_vocab = user_vocab
        self.item_vocab = item_vocab
        self._csr_user: Optional[CSR] = None
        self._csr_item: Optional[CSR] = None

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_text(
        cls,
        path: str,
        parser: LineParser = default_line_parser,
        skip_header: bool = False,
        user_vocab: Optional[Vocab] = None,
        item_vocab: Optional[Vocab] = None,
        use_native: Optional[bool] = None,
        num_threads: int = 0,
    ) -> "Interactions":
        """Stream a text file through ``parser`` (ref Data::load RECSYS path,
        src/base/data-inl.hpp:45-64 + FileLineReader, skipping blank lines).

        For the two built-in parsers the multithreaded C++ loader
        (cdae_jax/_native) is used when available; a custom ``parser``,
        ``skip_header`` or pre-seeded vocabs force the Python path.
        """
        if use_native is None:
            use_native = not skip_header and user_vocab is None and (
                item_vocab is None
            )
        native_fmt = {default_line_parser: "default",
                      movielens_line_parser: "movielens"}.get(parser)
        if use_native and native_fmt is not None:
            from cdae_jax import _native

            out = (
                _native.parse_text(path, native_fmt, num_threads)
                if _native.available()
                else None
            )
            if out is not None:
                users, items, ratings, u_tok, i_tok = out
                return cls(
                    users, items, ratings,
                    num_users=len(u_tok), num_items=len(i_tok),
                    user_vocab=Vocab.from_list(u_tok),
                    item_vocab=Vocab.from_list(i_tok),
                )
        user_vocab = user_vocab if user_vocab is not None else Vocab()
        item_vocab = item_vocab if item_vocab is not None else Vocab()
        users, items, ratings = [], [], []
        with open(path, "r") as f:
            for lineno, line in enumerate(f):
                if skip_header and lineno == 0:
                    continue
                line = line.strip()
                if not line:
                    continue
                parsed = parser(line)
                if parsed is None:
                    continue
                u, i, r = parsed
                users.append(user_vocab.add(u))
                items.append(item_vocab.add(i))
                ratings.append(float(r))
        return cls(
            np.asarray(users, dtype=np.int32),
            np.asarray(items, dtype=np.int32),
            np.asarray(ratings, dtype=np.float32),
            num_users=len(user_vocab),
            num_items=len(item_vocab),
            user_vocab=user_vocab,
            item_vocab=item_vocab,
        )

    @classmethod
    def from_arrays(
        cls,
        users: np.ndarray,
        items: np.ndarray,
        ratings: Optional[np.ndarray] = None,
        num_users: Optional[int] = None,
        num_items: Optional[int] = None,
    ) -> "Interactions":
        users = np.asarray(users)
        items = np.asarray(items)
        if ratings is None:
            ratings = np.ones(len(users), dtype=np.float32)
        if num_users is None:
            num_users = int(users.max()) + 1 if len(users) else 0
        if num_items is None:
            num_items = int(items.max()) + 1 if len(items) else 0
        return cls(users, items, ratings, num_users, num_items)

    # -- basic protocol -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.users)

    @property
    def size(self) -> int:
        return len(self.users)

    def __repr__(self) -> str:
        return (
            f"Interactions(n={len(self)}, users={self.num_users}, "
            f"items={self.num_items})"
        )

    def describe(self, head: int = 5) -> str:
        """Schema + head pretty-printer (ref Data operator<<,
        src/base/data-inl.hpp:82-105 prints dims, group sizes, head rows)."""
        lines = [
            repr(self),
            f"  density: {len(self) / max(self.num_users * self.num_items, 1):.6f}",
            f"  per-user interactions: min={int(self.csr().row_lengths().min()) if len(self) else 0} "
            f"max={int(self.csr().row_lengths().max()) if len(self) else 0} "
            f"mean={len(self) / max(self.num_users, 1):.1f}",
            "  head (user, item, rating):",
        ]
        for j in range(min(head, len(self))):
            u, i, r = self.users[j], self.items[j], self.ratings[j]
            uo = self.user_vocab.key(int(u)) if self.user_vocab else u
            io_ = self.item_vocab.key(int(i)) if self.item_vocab else i
            lines.append(f"    {uo} {io_} {r}")
        return "\n".join(lines)

    def with_dims(self, num_users: int, num_items: int) -> "Interactions":
        out = Interactions(
            self.users, self.items, self.ratings, num_users, num_items,
            self.user_vocab, self.item_vocab,
        )
        return out

    def shuffled(self, rng: np.random.Generator) -> "Interactions":
        """Row shuffle (ref Data::shuffle_data, src/base/data-inl.hpp:200)."""
        perm = rng.permutation(len(self))
        return Interactions(
            self.users[perm], self.items[perm], self.ratings[perm],
            self.num_users, self.num_items, self.user_vocab, self.item_vocab,
        )

    # -- views ----------------------------------------------------------------
    def csr(self) -> CSR:
        """Per-user sorted item lists (ref get_feature_to_vec_hashtable(0,1))."""
        if self._csr_user is None:
            self._csr_user = _build_csr(
                self.users, self.items, self.ratings, self.num_users
            )
        return self._csr_user

    def csr_by_item(self) -> CSR:
        """Per-item sorted user lists (ref get_feature_to_vec_hashtable(1,0))."""
        if self._csr_item is None:
            self._csr_item = _build_csr(
                self.items, self.users, self.ratings, self.num_items
            )
        return self._csr_item

    def user_item_dict(self) -> Dict[int, Dict[int, float]]:
        """uid -> {iid: rating}. Host-side equivalent of the reference's
        get_feature_pair_label_hashtable(0, 1) (src/base/data-inl.hpp:413-429).

        Note the reference's inner map uses ``insert`` so the FIRST duplicate
        wins; we replicate by keeping the first occurrence.
        """
        out: Dict[int, Dict[int, float]] = {u: {} for u in range(self.num_users)}
        for u, i, r in zip(self.users, self.items, self.ratings):
            d = out[int(u)]
            i = int(i)
            if i not in d:
                d[i] = float(r)
        return out

    def padded(self, max_len: Optional[int] = None) -> PaddedUserBatch:
        """Padded per-user item lists for ALL users (0..num_users-1).

        Items in each row are ascending; padding value is ``num_items``.
        """
        csr = self.csr()
        lengths = csr.row_lengths().astype(np.int32)
        L = int(lengths.max()) if max_len is None and len(lengths) else int(max_len or 1)
        L = max(L, 1)
        U = self.num_users
        items = np.full((U, L), self.num_items, dtype=np.int32)
        ratings = np.zeros((U, L), dtype=np.float32)
        # vectorized ragged→padded: position of each nnz within its row
        if len(csr.indices):
            rows = np.repeat(np.arange(U), np.diff(csr.indptr))
            pos = np.arange(len(csr.indices)) - csr.indptr[rows]
            keep = pos < L
            items[rows[keep], pos[keep]] = csr.indices[keep]
            ratings[rows[keep], pos[keep]] = csr.values[keep]
        lengths = np.minimum(lengths, L).astype(np.int32)
        mask = np.arange(L)[None, :] < lengths[:, None]
        return PaddedUserBatch(
            uids=np.arange(U, dtype=np.int32),
            items=items,
            ratings=ratings,
            mask=mask,
            lengths=lengths,
            num_items=self.num_items,
        )

    def dense_matrix(self, binary: bool = False) -> np.ndarray:
        """(num_users, num_items) dense rating matrix (small datasets only)."""
        m = np.zeros((self.num_users, self.num_items), dtype=np.float32)
        if binary:
            m[self.users, self.items] = 1.0
        else:
            # first-occurrence wins, matching user_item_dict semantics
            for u, i, r in zip(self.users[::-1], self.items[::-1], self.ratings[::-1]):
                m[u, i] = r
        return m

    # -- splits ---------------------------------------------------------------
    def random_split(
        self, test_ratio: float, seed: int = 0
    ) -> Tuple["Interactions", "Interactions"]:
        """Global random split (ref Data::random_split,
        src/base/data-inl.hpp:206-229)."""
        rng = np.random.default_rng(seed)
        n = len(self)
        perm = rng.permutation(n)
        num_train = int((1.0 - test_ratio) * n)
        tr, te = perm[:num_train], perm[num_train:]
        return self._take(tr), self._take(te)

    def split_by_user(
        self, test_ratio: float, seed: int = 0
    ) -> Tuple["Interactions", "Interactions"]:
        """Per-user leave-``test_ratio``-out split.

        Reference protocol (src/base/data-inl.hpp:231-272): bucket instances
        by user, shuffle each bucket, first floor(len*ratio) go to test, the
        rest to train; both splits share the full dimension info so every
        user exists in the training id space.
        """
        rng = np.random.default_rng(seed)
        if self.num_users > 100_000:
            # vectorized protocol for huge user counts (a python loop over
            # 10M buckets takes minutes): random order within each user via
            # one lexsort, first floor(count*ratio) positions go to test.
            # Same per-user sizes/disjointness; different (still seeded)
            # randomization than the small-U loop below.
            n = len(self)
            order = np.lexsort((rng.random(n), self.users))
            counts = np.bincount(self.users, minlength=self.num_users)
            indptr = np.zeros(self.num_users + 1, dtype=np.int64)
            indptr[1:] = np.cumsum(counts)
            pos = np.arange(n) - indptr[self.users[order]]
            k = np.floor(counts * test_ratio).astype(np.int64)
            is_test = pos < k[self.users[order]]
            te = order[is_test]
            tr = order[~is_test]
            rng.shuffle(tr)
            rng.shuffle(te)
            return self._take(tr), self._take(te)
        # bucket original COO positions by user (small-U path keeps the
        # historical seeded split bit-for-bit)
        order = np.argsort(self.users, kind="stable")
        counts = np.bincount(self.users, minlength=self.num_users)
        indptr = np.zeros(self.num_users + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(counts)
        train_idx, test_idx = [], []
        for u in range(self.num_users):
            bucket = order[indptr[u] : indptr[u + 1]].copy()
            rng.shuffle(bucket)
            k = int(len(bucket) * test_ratio)
            test_idx.append(bucket[:k])
            train_idx.append(bucket[k:])
        tr = np.concatenate(train_idx) if train_idx else np.empty(0, np.int64)
        te = np.concatenate(test_idx) if test_idx else np.empty(0, np.int64)
        rng.shuffle(tr)
        rng.shuffle(te)
        return self._take(tr), self._take(te)

    def _take(self, idx: np.ndarray) -> "Interactions":
        return Interactions(
            self.users[idx], self.items[idx], self.ratings[idx],
            self.num_users, self.num_items, self.user_vocab, self.item_vocab,
        )


def rows_from_csr(csr, users: np.ndarray, num_items: int):
    """Padded (len(users), L) item/rating/mask rows for SPECIFIC users,
    straight from CSR — O(selected nnz) instead of O(U·max_len) for a full
    padded matrix. L = max row length among the selected users (min 1)."""
    lengths = np.diff(csr.indptr)[users].astype(np.int32)
    L = max(int(lengths.max()) if len(lengths) else 1, 1)
    n = len(users)
    items = np.full((n, L), num_items, dtype=np.int32)
    ratings = np.zeros((n, L), dtype=np.float32)
    # vectorized ragged copy (no per-row python loop)
    counts = lengths.astype(np.int64)
    total = int(counts.sum())
    if total:
        row_of = np.repeat(np.arange(n), counts)
        cum0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(total) - np.repeat(cum0, counts)
        src = np.repeat(csr.indptr[users], counts) + pos
        items[row_of, pos] = csr.indices[src]
        ratings[row_of, pos] = csr.values[src]
    mask = np.arange(L)[None, :] < lengths[:, None]
    return items, ratings, mask, lengths



def _build_csr(
    keys: np.ndarray, vals: np.ndarray, ratings: np.ndarray, num_keys: int
) -> CSR:
    from cdae_jax import _native

    if len(keys) > 100_000 and _native.available():
        out = _native.build_csr(keys, vals, ratings, num_keys)
        if out is not None:
            indptr, indices, values = out
            return CSR(indptr=indptr, indices=indices, values=values)
    # single lexsort: primary key = row, secondary = column (ascending)
    order = np.lexsort((vals, keys))
    sorted_keys = keys[order]
    indices = vals[order]
    values = ratings[order]
    indptr = np.zeros(num_keys + 1, dtype=np.int64)
    counts = np.bincount(sorted_keys, minlength=num_keys) if len(keys) else np.zeros(num_keys, np.int64)
    indptr[1:] = np.cumsum(counts)
    return CSR(indptr=indptr, indices=indices.astype(np.int32),
               values=values.astype(np.float32))
