"""Grouped sparse feature instances for the generic (non-recsys) models.

Batched equivalent of the reference's Instance/FeatureGroup containers and
the global-index instance iterator (ref: src/base/instance.hpp:17-225,
src/base/data-inl.hpp:107-199): each instance carries features living in
feature GROUPS; a feature's global index is its in-group index plus the
group's offset (ref data-inl.hpp:70-76 computes the offsets). LinearModel /
FactorModel / NegMF consume this view (ref src/model/linear_model-inl.hpp:25,
factor_model-inl.hpp:34-63 iterate `data_->begin(ins)`).

Dense layout: ``idx (N, F) int32`` global feature indices, ``vals (N, F)``
float32, ``mask (N, F)`` for ragged instances, and a STATIC ``group_of (F,)``
map saying which feature group each slot belongs to (the reference's
cross-group-only FM interactions need it, factor_model-inl.hpp:54-58).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from cdae_jax.data.dataset import Interactions


@dataclasses.dataclass
class GroupedInstances:
    idx: np.ndarray  # (N, F) int32 global feature indices
    vals: np.ndarray  # (N, F) float32
    mask: np.ndarray  # (N, F) bool
    labels: np.ndarray  # (N,) float32
    group_of: Tuple[int, ...]  # static: group id of each feature slot
    group_dims: Tuple[int, ...]  # per-group dimension
    total_dim: int

    def __len__(self) -> int:
        return self.idx.shape[0]

    def head(self, n: int) -> "GroupedInstances":
        """First-n instance view — the data_loss(sample_size) subsampling
        unit (ref linear_model.hpp:51-54 loops the first sample_size
        instances in dataset order)."""
        n = min(int(n), len(self))
        return GroupedInstances(
            idx=self.idx[:n], vals=self.vals[:n], mask=self.mask[:n],
            labels=self.labels[:n], group_of=self.group_of,
            group_dims=self.group_dims, total_dim=self.total_dim,
        )

    @property
    def num_slots(self) -> int:
        return self.idx.shape[1]

    @classmethod
    def from_interactions(cls, data: Interactions) -> "GroupedInstances":
        """RECSYS schema: group 0 = user id, group 1 = item id, value 1
        (ref Data::load RECSYS path + apps/yelp/yelp.cpp:60-66)."""
        n = len(data)
        idx = np.stack(
            [data.users.astype(np.int32),
             (data.items + data.num_users).astype(np.int32)],
            axis=1,
        )
        return cls(
            idx=idx,
            vals=np.ones((n, 2), dtype=np.float32),
            mask=np.ones((n, 2), dtype=bool),
            labels=data.ratings.astype(np.float32),
            group_of=(0, 1),
            group_dims=(data.num_users, data.num_items),
            total_dim=data.num_users + data.num_items,
        )

    @classmethod
    def from_arrays(
        cls,
        group_indices: Sequence[np.ndarray],  # per-group (N,) in-group idx
        group_dims: Sequence[int],
        labels: np.ndarray,
        group_values: Optional[Sequence[np.ndarray]] = None,
    ) -> "GroupedInstances":
        offsets = np.concatenate([[0], np.cumsum(group_dims)])[:-1]
        cols = [
            np.asarray(gi, dtype=np.int32) + int(off)
            for gi, off in zip(group_indices, offsets)
        ]
        idx = np.stack(cols, axis=1)
        n, f = idx.shape
        if group_values is None:
            vals = np.ones((n, f), dtype=np.float32)
        else:
            vals = np.stack(
                [np.asarray(v, dtype=np.float32) for v in group_values], axis=1
            )
        return cls(
            idx=idx,
            vals=vals,
            mask=np.ones((n, f), dtype=bool),
            labels=np.asarray(labels, dtype=np.float32),
            group_of=tuple(range(len(group_dims))),
            group_dims=tuple(int(d) for d in group_dims),
            total_dim=int(sum(group_dims)),
        )
