"""Evaluation edge cases."""

import numpy as np
import pytest

from cdae_jax.data.dataset import Interactions
from cdae_jax.evaluation import Evaluation
from cdae_jax.models.popularity import Popularity


def test_empty_validation():
    train = Interactions.from_arrays(
        np.array([0, 1]), np.array([0, 1]), num_users=2, num_items=3
    )
    empty = Interactions.from_arrays(
        np.array([], dtype=np.int32), np.array([], dtype=np.int32),
        num_users=2, num_items=3,
    )
    model = Popularity()
    state = model.reset(train)
    res = Evaluation.create("TOPN").evaluate(model, state, empty, train)
    assert res["R@10"] == 0.0


def test_val_user_with_no_train_items():
    """A validation user who rated nothing in train still gets a rec list
    (full catalog unmasked)."""
    train = Interactions.from_arrays(
        np.array([0, 0, 1]), np.array([0, 1, 2]), num_users=3, num_items=5
    )
    val = Interactions.from_arrays(
        np.array([2]), np.array([3]), num_users=3, num_items=5
    )
    model = Popularity()
    state = model.reset(train)
    res = Evaluation.create("TOPN").evaluate(model, state, val, train)
    # item 3 has zero popularity but the catalog is only 5 items; it appears
    # somewhere in the top-10 -> R@10 == 1
    assert res["R@10"] == 1.0


def test_eval_caches_per_dataset_pair():
    train = Interactions.from_arrays(
        np.array([0, 1]), np.array([0, 1]), num_users=2, num_items=3
    )
    val = Interactions.from_arrays(
        np.array([0]), np.array([2]), num_users=2, num_items=3
    )
    ev = Evaluation.create("TOPN")
    model = Popularity()
    state = model.reset(train)
    r1 = ev.evaluate(model, state, val, train)
    r2 = ev.evaluate(model, state, val, train)  # cached batches path
    for k in r1:
        if k != "TestTime":
            assert r1[k] == r2[k]
