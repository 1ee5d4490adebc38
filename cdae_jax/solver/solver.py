"""Training orchestration (ref: src/solver/solver.hpp:11-46, solver-inl.hpp:5-112).

``Solver`` owns the outer loop: reset -> pre_train -> [iteration 0 eval] ->
loop {train_one_iteration, current_loss, eval every ``eval_iterations``},
logging a fixed-width table row per eval exactly in the reference's shape
(Iters | Time | Train Loss | <evaluator columns...>, solver-inl.hpp:24-69).

``SGDSolver`` mirrors SGD<Model> (ref src/solver/sgd.hpp:24-70): it carries
the learn-rate schedule (constant by default; optional inverse-time decay
lr0/(1+lr0*lambda*steps), ref sgd-inl.hpp:84-91) and hands the current rate
to the model each iteration.

Differences from the reference: model state (params + optimizer accumulators + rng)
is an explicit value threaded through the loop (functional, jit-friendly),
and evaluation runs as batched on-device pipelines (evaluation.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax

import os

from cdae_jax.data.dataset import Interactions
from cdae_jax.evaluation import Evaluation, EvalType
from cdae_jax.utils.logging import get_logger
from cdae_jax.utils.timer import Timer

logger = get_logger()


def _params_finite(params) -> bool:
    """One fused all-isfinite over every param leaf + a scalar readback."""
    import jax.numpy as jnp

    leaves = jax.tree_util.tree_leaves(params)
    ok = jnp.array(True)
    for x in leaves:
        if jnp.issubdtype(x.dtype, jnp.floating):
            ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(x)))
    return bool(ok)


def _fmt_metrics(res: Dict[str, float]) -> str:
    return " ".join(
        f"{k}={v:.5f}" for k, v in res.items() if k != "TestTime"
    ) + f" TestTime={res.get('TestTime', 0.0):.2f}s"


class Solver:
    """Generic trainer over the model protocol (models/base.py)."""

    def __init__(
        self,
        model,
        max_iteration: int = 1,
        eval_iterations: int = 1,
        seed: int = 0,
        verbose: bool = True,
        trace_dir: Optional[str] = None,
        guard: bool = False,
        guard_max_restores: int = 1,
        loss_sample_size: int = 0,
    ):
        self.model = model
        self.max_iteration = int(max_iteration)
        self.eval_iterations = max(int(eval_iterations), 1)
        self.seed = seed
        self.verbose = verbose
        self.trace_dir = trace_dir  # jax.profiler trace output (SURVEY §5)
        # in-run fault handling (SURVEY §5 failure detection; a
        # superset — the reference has none): when ``guard`` is on, every
        # iteration's params are checked finite (one fused all-isfinite +
        # scalar readback). A non-finite state (transient device fault, bad
        # collective, overflow) restores the last exact-resume checkpoint —
        # params, optimizer accumulators, step AND the solver PRNG stream —
        # and replays from there, up to ``guard_max_restores`` times so a
        # DETERMINISTIC divergence still surfaces instead of looping.
        self.guard = bool(guard)
        self.guard_max_restores = int(guard_max_restores)
        # subsample the per-iteration train-loss estimate (forwarded to
        # model.current_loss(state, n) — the reference's data_loss
        # sample_size knob, model_base.hpp:28-39): at config-5 scale the
        # FULL data_loss re-forwards every batch each iteration and can
        # rival the training step itself; 0 = full dataset (reference
        # default)
        self.loss_sample_size = int(loss_sample_size)
        self.state = None
        self.history: List[Dict[str, float]] = []

    # hooks (ref solver.hpp:27-33)
    def pre_train(self, train_data: Interactions, validation_data) -> None:
        pass

    def train_one_iteration(self, train_data: Interactions, rng_key):
        self.state = self.model.train_one_iteration(self.state, rng_key)

    def post_resume(self, start_iteration: int, train_data) -> None:
        """Hook: realign any solver-side schedule state after a resume."""

    def _log(self, msg: str) -> None:
        if self.verbose and jax.process_index() == 0:
            logger.info(msg)

    def _eval_row(
        self, iteration, t, train_loss, evaluations, validation_data, train_data
    ) -> Dict[str, float]:
        row: Dict[str, float] = {
            "iter": float(iteration),
            "time": t.elapsed(),
            "train_loss": float(train_loss),
        }
        parts = [
            f"{iteration:5d}|{t.elapsed():8.3f}|{train_loss:10.5g}|"
        ]
        if validation_data is not None and len(validation_data) > 0:
            for ev in evaluations:
                res = ev.evaluate(self.model, self.state, validation_data, train_data)
                row.update(res)
                parts.append(_fmt_metrics(res) + "|")
        self._log("".join(parts))
        self.history.append(row)
        return row

    def train(
        self,
        train_data: Interactions,
        validation_data: Optional[Interactions] = None,
        eval_types: Sequence = (),
        resume_from: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
    ):
        """The reference training loop (solver-inl.hpp:5-79).

        Superset of the reference: ``resume_from`` restores an exact-resume
        checkpoint (params + optimizer accumulators + step + the solver's
        PRNG stream value), after which the run is bitwise-identical to an
        unbroken one; ``checkpoint_path``/``checkpoint_every`` write such
        checkpoints mid-run (and at the end when a path is given).
        """
        from cdae_jax.utils import checkpoint as ckpt

        evaluations = [Evaluation.create(t) for t in eval_types]
        self.history = []

        self.state = self.model.reset(train_data, seed=self.seed)
        self.pre_train(train_data, validation_data)
        rng = jax.random.PRNGKey(self.seed)
        start_iteration = 0
        fingerprint = ckpt.config_fingerprint(self.model, self.state)
        if resume_from:
            ckpt.load_checkpoint(resume_from, self.state,
                                 expect_fingerprint=fingerprint)
            saved_rng = ckpt.checkpoint_rng_key(resume_from)
            if saved_rng is not None:
                rng = saved_rng
            start_iteration = self.state.step
            self.post_resume(start_iteration, train_data)
            self._log(
                f"resumed {resume_from} at iteration {start_iteration}"
                + ("" if saved_rng is not None
                   else " (no rng in checkpoint: stream restarts)")
            )

        def write_ckpt():
            if checkpoint_path:
                ckpt.save_checkpoint(
                    checkpoint_path, self.state,
                    extra={"model": type(self.model).__name__},
                    rng_key=rng, fingerprint=fingerprint,
                )

        t = Timer()
        self._log("-" * 110)
        header = f"{'Iters':>5}|{'Time':>8}|{'Train Loss':>10}|"
        if validation_data is not None and len(validation_data) > 0:
            header += "".join(
                " ".join(ev.columns) + "|" for ev in evaluations
            )
        self._log(header)

        train_loss = 0.0
        self._eval_row(start_iteration, t, train_loss, evaluations,
                       validation_data, train_data)

        from cdae_jax.utils.profiling import trace

        iteration = start_iteration
        restores = 0
        with trace(self.trace_dir):
            while iteration < self.max_iteration:
                rng, sub = jax.random.split(rng)
                self.train_one_iteration(train_data, sub)
                if self.guard and not _params_finite(self.state.params):
                    if (checkpoint_path and os.path.exists(checkpoint_path)
                            and restores < self.guard_max_restores):
                        restores += 1
                        ckpt.load_checkpoint(checkpoint_path, self.state,
                                             expect_fingerprint=fingerprint)
                        saved = ckpt.checkpoint_rng_key(checkpoint_path)
                        if saved is not None:
                            rng = saved
                        iteration = self.state.step
                        self._log(
                            f"non-finite params at iteration "
                            f"{self.state.step}; restored {checkpoint_path} "
                            f"(restore {restores}/"
                            f"{self.guard_max_restores})"
                        )
                        continue
                    raise RuntimeError(
                        f"non-finite parameters detected at iteration "
                        f"{iteration + 1}"
                        + ("" if not checkpoint_path else
                           f" after {restores} restore(s)")
                    )
                train_loss = self.model.current_loss(
                    self.state, self.loss_sample_size)
                iteration += 1
                if iteration % self.eval_iterations == 0:
                    self._eval_row(
                        iteration, t, train_loss, evaluations,
                        validation_data, train_data,
                    )
                if checkpoint_every and iteration % checkpoint_every == 0:
                    write_ckpt()
        write_ckpt()
        self._log("-" * 110)
        return self.state

    def test(self, test_data: Interactions, eval_types: Sequence = (),
             train_data: Optional[Interactions] = None) -> Dict[str, float]:
        """One-shot evaluation pass (ref solver-inl.hpp:81-112)."""
        t = Timer()
        out: Dict[str, float] = {}
        for ev in (Evaluation.create(k) for k in eval_types):
            out.update(ev.evaluate(self.model, self.state, test_data, train_data))
        out["time"] = t.elapsed()
        self._log(
            f"{t.elapsed():8.3f}|"
            + " ".join(f"{k}={v:.5f}" for k, v in out.items() if k != "time")
        )
        return out


class SGDSolver(Solver):
    """SGD<Model> equivalent (ref src/solver/sgd.hpp:24-70).

    The learn-rate lives in the solver (ref SGDConfig sgd.hpp:13-21);
    ``adaptive`` enables the inverse-time decay the reference ships
    disabled (sgd-inl.hpp:84-91).
    """

    def __init__(
        self,
        model,
        max_iteration: int = 1,
        eval_iterations: int = 1,
        learn_rate: Optional[float] = None,
        lambda_: float = 0.0,
        adaptive: bool = False,
        seed: int = 0,
        verbose: bool = True,
        trace_dir: Optional[str] = None,
        guard: bool = False,
        guard_max_restores: int = 1,
        loss_sample_size: int = 0,
    ):
        super().__init__(model, max_iteration, eval_iterations, seed, verbose,
                         trace_dir, guard, guard_max_restores,
                         loss_sample_size)
        self.learn_rate0 = learn_rate
        self.lambda_ = lambda_
        self.adaptive = adaptive
        self._steps = 0

    def pre_train(self, train_data, validation_data) -> None:
        # ref sgd-inl.hpp:93-102: push the configured rate into the model
        if self.learn_rate0 is not None and hasattr(self.model, "set_learn_rate"):
            self.model.set_learn_rate(self.learn_rate0)
        self._steps = 0

    def train_one_iteration(self, train_data, rng_key):
        super().train_one_iteration(train_data, rng_key)
        self._steps += len(train_data)
        self._apply_schedule()

    def post_resume(self, start_iteration: int, train_data) -> None:
        # the inverse-time schedule depends only on total instance count —
        # replay it so a resumed run sees the same lr as an unbroken one
        self._steps = start_iteration * len(train_data)
        self._apply_schedule()

    def _apply_schedule(self) -> None:
        if (
            self.adaptive
            and self.learn_rate0 is not None
            and hasattr(self.model, "set_learn_rate")
        ):
            lr = self.learn_rate0 / (
                1.0 + self.learn_rate0 * self.lambda_ * self._steps
            )
            self.model.set_learn_rate(lr)
