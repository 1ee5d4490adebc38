"""End-to-end solver + evaluation + CDAE tests.

Mirrors the reference's integration test strategy (test/model_test.hpp:18-79)
but asserts metric movement, not just absence of crashes.
"""

import jax
import numpy as np
import pytest

from cdae_jax.data.dataset import Interactions, movielens_line_parser
from cdae_jax.evaluation import Evaluation
from cdae_jax.models.cdae import CDAE, CDAEConfig
from cdae_jax.solver.solver import Solver, SGDSolver


@pytest.fixture(scope="module")
def splits(movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    return data.split_by_user(0.2, seed=20141119)


def _run_cdae(splits, cfg, iters=12, eval_iterations=None):
    train, test = splits
    model = CDAE(cfg)
    solver = Solver(model, max_iteration=iters,
                    eval_iterations=eval_iterations or iters,
                    seed=1, verbose=False)
    solver.train(train, test, ["TOPN"])
    return solver


def test_cdae_learns_topn(splits):
    solver = _run_cdae(
        splits,
        CDAEConfig(num_dim=10, learn_rate=0.1, lambda_=0.01, loss="SQUARE",
                   corruption_ratio=0.2, num_neg=5, batch_size=32),
        iters=15, eval_iterations=5,
    )
    first, last = solver.history[0], solver.history[-1]
    assert last["R@10"] > first["R@10"] + 0.1
    assert last["R@10"] > 0.3
    # training loss decreases across the run
    losses = [h["train_loss"] for h in solver.history[1:]]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize(
    "variant",
    [
        dict(asymmetric=True),
        dict(user_factor=False),
        dict(tanh=True),
        dict(linear=True),
        dict(linear_function=True),
        dict(scaled=False, corruption_ratio=0.5),
        dict(loss="CE"),
        dict(using_adagrad=False, learn_rate=0.01),
    ],
)
def test_cdae_variants_train(splits, variant):
    base = dict(num_dim=8, learn_rate=0.1, lambda_=0.01, loss="SQUARE",
                corruption_ratio=0.2, num_neg=3, batch_size=32)
    base.update(variant)
    solver = _run_cdae(splits, CDAEConfig(**base), iters=6)
    last = solver.history[-1]
    assert np.isfinite(last["train_loss"])
    assert last["R@10"] >= 0.0


def test_solver_eval_cadence(splits):
    train, test = splits
    model = CDAE(CDAEConfig(num_dim=4, batch_size=32, loss="SQUARE"))
    solver = Solver(model, max_iteration=4, eval_iterations=2,
                    seed=0, verbose=False)
    solver.train(train, test, ["TOPN"])
    # rows at iterations 0, 2, 4 (ref solver-inl.hpp:37-76 cadence)
    assert [h["iter"] for h in solver.history] == [0.0, 2.0, 4.0]
    assert all("P@10" in h for h in solver.history)


def test_ranking_evaluation_runs(splits):
    train, test = splits
    model = CDAE(CDAEConfig(num_dim=4, batch_size=32, loss="SQUARE"))
    solver = Solver(model, max_iteration=2, eval_iterations=2,
                    seed=0, verbose=False)
    solver.train(train, test, ["TOPN", "RANKING"])
    last = solver.history[-1]
    assert "NDCG@10" in last and 0.0 <= last["NDCG@10"] <= 1.0


def test_pointwise_evaluation_with_stub_model(splits):
    train, test = splits

    class Stub:
        def predict(self, state, users, items):
            return np.full(len(users), 3.0, dtype=np.float32)

    ev = Evaluation.create("RMSE", batch_size=7)
    res = ev.evaluate(Stub(), None, test)
    expected = float(np.sqrt(np.mean((3.0 - test.ratings) ** 2)))
    assert res["RMSE"] == pytest.approx(expected, rel=1e-5)
    ev = Evaluation.create("MAE")
    res = ev.evaluate(Stub(), None, test)
    assert res["MAE"] == pytest.approx(float(np.mean(np.abs(3.0 - test.ratings))), rel=1e-5)


def test_determinism_same_seed(splits):
    """SPMD replaces Hogwild races: same seed => bitwise-same metrics
    (SURVEY §5: determinism tests instead of race detection)."""
    r1 = _run_cdae(splits, CDAEConfig(num_dim=6, batch_size=32, loss="SQUARE"), iters=3)
    r2 = _run_cdae(splits, CDAEConfig(num_dim=6, batch_size=32, loss="SQUARE"), iters=3)
    h1, h2 = r1.history[-1], r2.history[-1]
    assert h1["train_loss"] == h2["train_loss"]
    assert h1["R@10"] == h2["R@10"]


def test_cdae_pooled_negatives_learn(splits):
    """neg_pool (huge-catalog pooled negatives) reaches the same quality
    band as exact complement sampling (CDAEConfig.neg_pool docstring;
    convergence-equivalent at a modest epoch premium)."""
    solver = _run_cdae(
        splits,
        CDAEConfig(num_dim=10, learn_rate=0.1, lambda_=0.01, loss="SQUARE",
                   corruption_ratio=0.2, num_neg=5, batch_size=32,
                   dense_mode=False, neg_pool=24),
        iters=20, eval_iterations=20,
    )
    assert solver.history[-1]["R@10"] > 0.3


def test_cdae_bfloat16_trains(splits):
    """bf16 parameter dtype runs end to end (tensor-core friendly); f32 remains
    the default (bf16 AdaGrad accumulators trade some accuracy)."""
    import jax.numpy as jnp

    solver = _run_cdae(
        splits,
        CDAEConfig(num_dim=8, loss="SQUARE", corruption_ratio=0.2,
                   batch_size=32, dtype=jnp.bfloat16),
        iters=5,
    )
    last = solver.history[-1]
    assert np.isfinite(last["train_loss"])


class _FaultyCDAE(CDAE):
    """CDAE that corrupts its params to NaN on selected iterations —
    simulates a transient device fault for the solver guard tests."""

    def __init__(self, cfg, fault_steps):
        super().__init__(cfg)
        self.fault_steps = set(fault_steps)
        self.calls = 0

    def train_one_iteration(self, state, rng_key):
        state = super().train_one_iteration(state, rng_key)
        self.calls += 1
        if self.calls in self.fault_steps:
            import jax.numpy as jnp

            state.params["W"] = state.params["W"] * jnp.nan
        return state


def test_guard_restores_from_checkpoint_on_transient_fault(splits, tmp_path):
    """In-run fault handling (SURVEY §5 superset): a transient NaN state is
    detected, the last exact-resume checkpoint restored (params + PRNG
    stream), and training completes with fully finite parameters."""
    train, test = splits
    ckpt_path = str(tmp_path / "guard.npz")
    model = _FaultyCDAE(
        CDAEConfig(num_dim=8, loss="SQUARE", corruption_ratio=0.2,
                   num_neg=2, batch_size=16),
        fault_steps={3},  # fault once, after the step-2 checkpoint
    )
    solver = Solver(model, max_iteration=4, eval_iterations=4, seed=0,
                    verbose=False, guard=True)
    state = solver.train(train, test, ["TOPN"],
                         checkpoint_path=ckpt_path, checkpoint_every=2)
    assert state.step == 4
    # the faulted iteration was replayed: 4 clean + 1 faulted call
    assert model.calls == 5
    for k, v in state.params.items():
        assert np.isfinite(np.asarray(v)).all(), k


def test_guard_raises_without_checkpoint(splits):
    train, test = splits
    model = _FaultyCDAE(
        CDAEConfig(num_dim=8, loss="SQUARE", corruption_ratio=0.2,
                   num_neg=2, batch_size=16),
        fault_steps={1},
    )
    solver = Solver(model, max_iteration=2, eval_iterations=2, seed=0,
                    verbose=False, guard=True)
    with pytest.raises(RuntimeError, match="non-finite"):
        solver.train(train, test, ["TOPN"])


def test_guard_surfaces_deterministic_divergence(splits, tmp_path):
    """A fault that reproduces after every restore must raise once the
    restore budget is spent — never loop forever."""
    train, test = splits
    ckpt_path = str(tmp_path / "guard2.npz")
    model = _FaultyCDAE(
        CDAEConfig(num_dim=8, loss="SQUARE", corruption_ratio=0.2,
                   num_neg=2, batch_size=16),
        fault_steps={3, 4, 5, 6},  # every replay of step 3 faults again
    )
    solver = Solver(model, max_iteration=4, eval_iterations=4, seed=0,
                    verbose=False, guard=True, guard_max_restores=2)
    with pytest.raises(RuntimeError, match="restore"):
        solver.train(train, test, ["TOPN"],
                     checkpoint_path=ckpt_path, checkpoint_every=2)


def test_solver_loss_sample_size(splits):
    """Solver(loss_sample_size=n) logs the SUBSAMPLED train loss — the
    reference's data_loss(sample_size) protocol wired through the loop
    (model_base.hpp:28-39; honored by LinearModel)."""
    from cdae_jax.models.linear import LinearModel, LinearModelConfig

    train, test = splits
    full = Solver(LinearModel(LinearModelConfig(batch_size=64)),
                  max_iteration=2, eval_iterations=2, seed=0, verbose=False)
    full.train(train, test, [])
    sub = Solver(LinearModel(LinearModelConfig(batch_size=64)),
                 max_iteration=2, eval_iterations=2, seed=0, verbose=False,
                 loss_sample_size=20)
    sub.train(train, test, [])
    assert 0.0 < sub.history[-1]["train_loss"] < full.history[-1]["train_loss"]
    # and the subsampled value matches a direct data_loss call
    model = sub.model
    expect = model.current_loss(sub.state, 20)
    assert abs(sub.history[-1]["train_loss"] - expect) < 1e-6
