"""CLI entry point — the equivalent of the reference yelp app
(ref: apps/yelp/yelp.cpp:23-205).

Flag surface matches the reference's gflags one-to-one so the paper's sweep
grids (ref apps/yelp/cdae.sh:3-36) translate directly; extra flags
(batch size, max iterations, eval cadence, checkpoints, mesh shape) are
additive. Tasks:

  prepare  — parse the text input, build vocabs, write the compressed cache
             (ref yelp.cpp:68-72)
  split    — per-user 80/20 split of the cache, write train/test caches
             (ref yelp.cpp:74-85)
  train    — split (or load split caches) and train --method, evaluating
             TOPN per cadence (ref yelp.cpp:87-104 — NOTE the reference has
             a missing `else if` so its train task returns -1; the intended
             control flow is implemented here, see SURVEY §"quirks")
  test     — load split caches, restore --init_checkpoint, evaluate

Run: ``python -m cdae_jax.cli --task train --method CDAE ...``
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from cdae_jax.data import io as data_io
from cdae_jax.data.dataset import (
    Interactions,
    default_line_parser,
    movielens_line_parser,
)
from cdae_jax.utils.logging import get_logger

logger = get_logger()

PARSERS = {
    "default": default_line_parser,  # "user item" → label 1 (yelp.cpp:60-66)
    "movielens": movielens_line_parser,  # "u::i::r::ts"
}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cdae_jax",
        description="JAX collaborative filtering (libcf capability)",
    )
    # -- reference flag surface (yelp.cpp:23-47) --
    p.add_argument("--input_file", default="./yelp_10core.txt")
    p.add_argument("--cache_file", default="./yelp.bin")
    p.add_argument("--train_cache_file", default="./yelp.train.bin")
    p.add_argument("--test_cache_file", default="./yelp.test.bin")
    p.add_argument("--task", default="train",
                   choices=["prepare", "split", "train", "test", "sweep"])
    p.add_argument("--seed", type=int, default=20141119)
    p.add_argument("--method", default="NONE")
    p.add_argument("--num_dim", type=int, default=10)
    p.add_argument("--num_neg", type=int, default=5)
    p.add_argument("--learn_rate", type=float, default=0.1)
    p.add_argument("--adagrad", type=_booly, default=True)
    p.add_argument("--bias", type=_booly, default=True)
    p.add_argument("--linear_function", type=_booly, default=False)
    p.add_argument("--tanh", type=_booly, default=False)
    p.add_argument("--asym", type=_booly, default=False)
    p.add_argument("--linear", type=_booly, default=False)
    p.add_argument("--scaled", type=_booly, default=False)
    p.add_argument("--user_factor", type=_booly, default=True)
    p.add_argument("--linear_output", type=_booly, default=False,
                   help="accepted for sweep-grid compatibility; a no-op "
                        "exactly like the reference (yelp.cpp:41 defines it "
                        "but maps it to no CDAEConfig field — the decoder "
                        "is always linear)")
    p.add_argument("--num_thread", type=int, default=0,
                   help="native loader threads (ref --num_thread; 0 = auto)")
    p.add_argument("--cnum", type=int, default=1)
    p.add_argument("--cratio", type=float, default=0.0)
    p.add_argument("--loss_type", default="SQUARE")
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--lambda", dest="lambda_", type=float, default=0.01)
    # -- build additions --
    p.add_argument("--parser", default="default", choices=sorted(PARSERS))
    p.add_argument("--max_iters", type=int, default=50)
    p.add_argument("--eval_iters", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--test_ratio", type=float, default=0.2)
    p.add_argument("--eval", default="TOPN",
                   help="comma-separated eval types (TOPN,RANKING,RMSE,MAE)")
    p.add_argument("--rel_threshold", type=float, default=4.0,
                   help="RANKING relevance cut for a hit (ref hardcodes 4)")
    p.add_argument("--checkpoint", default="",
                   help="path to write the final model checkpoint")
    p.add_argument("--init_checkpoint", default="",
                   help="restore params before training/testing; on the "
                        "train task this is an exact resume (params + "
                        "optimizer accumulators + PRNG stream)")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="write --checkpoint every N iterations (exact-"
                        "resume checkpoints; 0 = only at the end)")
    p.add_argument("--guard_nan", type=_booly, default=False,
                   help="per-iteration finite-params check; restores the "
                        "last --checkpoint on a non-finite state (in-run "
                        "fault handling, a superset of the reference)")
    p.add_argument("--loss_sample", type=int, default=0,
                   help="subsample the per-iteration train-loss estimate "
                        "to the first N instances (the reference's "
                        "data_loss sample_size knob; 0 = full dataset)")
    p.add_argument("--sweep_limit", type=int, default=0,
                   help="sweep task: run only the first N grid points")
    p.add_argument("--trace_dir", default="",
                   help="write a jax.profiler trace of the training loop")
    p.add_argument("--dense_mode", default="auto",
                   help="full-catalog dense training: auto|true|false")
    p.add_argument("--warp_pool", type=int, default=0,
                   help="WARP: pooled candidate negatives of this size "
                        "(MFConfig.warp_pool; works with and without the "
                        "dense rated mask). 0 = off")
    p.add_argument("--num_shared_neg", type=int, default=32,
                   help="BPR dense slab: shared negative draws per user "
                        "(MFConfig.num_shared_neg)")
    p.add_argument("--epoch_chunk", type=int, default=0,
                   help="max scan steps per device dispatch "
                        "(MFConfig.epoch_chunk; required at ~1M-item scale)."
                        " 0 = whole epoch fused")
    p.add_argument("--bf16_compute", type=_booly, default=False,
                   help="bf16 matmul operands (f32 masters + accumulators)")
    p.add_argument("--skip_popularity", action="store_true",
                   help="skip the always-run Popularity baseline "
                        "(ref yelp.cpp:110-113 always trains it first)")
    p.add_argument("--sim_type", default="JACCARD",
                   help="ITEMCF/USERCF similarity (JACCARD|COSINE)")
    p.add_argument("--sim_topk", type=int, default=50)
    p.add_argument("--scalar", type=float, default=40.0, help="WRMF scale")
    p.add_argument("--alpha", type=int, default=1, help="FISM alpha")
    p.add_argument("--sharded", type=_booly, default=False,
                   help="multi-chip: wrap --method in its mesh-sharded "
                        "trainer over a ('data','model') device mesh")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="devices on the 'model' (item) mesh axis; the rest "
                        "go to 'data'")
    p.add_argument("--shard_items", type=_booly, default=False,
                   help="with --sharded: item-sharded TP for the sparse MF "
                        "family (ShardedMFTP) — item tables + AdaGrad state "
                        "split over 'model' for catalogs beyond one chip")
    p.add_argument("--platform", default="",
                   help="force a jax platform (e.g. 'cpu'); applies "
                        "jax.config.update before first device use")
    return p


def _booly(v: str) -> bool:
    return str(v).lower() in ("1", "true", "t", "yes", "y")


def build_model(args):
    """--method dispatch (ref yelp.cpp:115-199; MF is the IMF model)."""
    from cdae_jax import models as M

    method = args.method.upper()
    loss = args.loss_type
    if method in ("POP", "POPULARITY"):
        return M.Popularity()
    if method in ("ITEMCF", "USERCF"):
        cls = M.ItemCF if method == "ITEMCF" else M.UserCF
        return cls(M.SimilarityConfig(sim_type=args.sim_type,
                                      topk=args.sim_topk))
    if method in ("MF", "IMF", "PMF", "BPR", "WARP"):
        cls = {"MF": M.IMF, "IMF": M.IMF, "PMF": M.PMF,
               "BPR": M.BPR, "WARP": M.WARP}[method]
        return cls(M.MFConfig(
            learn_rate=args.learn_rate, beta=args.beta, lambda_=args.lambda_,
            loss=loss, num_dim=args.num_dim, num_neg=args.num_neg,
            using_bias_term=args.bias, using_adagrad=args.adagrad,
            batch_size=args.batch_size,
            # --dense_mode true opts BPR/WARP into the per-user slab steps
            # (pair with ~2x --learn_rate — see MFConfig/BASELINE.md)
            dense_mode=(None if args.dense_mode == "auto"
                        else _booly(args.dense_mode)),
            warp_pool=(args.warp_pool or None),
            num_shared_neg=args.num_shared_neg,
            epoch_chunk=(args.epoch_chunk or None),
        ))
    if method in ("ALS", "WRMF"):
        cls = M.ALS if method == "ALS" else M.WRMF
        return cls(M.ALSConfig(lambda_=args.lambda_, scalar=args.scalar,
                               num_dim=args.num_dim))
    if method in ("FISM", "FISMPAIR"):
        cls = M.FISM if method == "FISM" else M.FISMPair
        return cls(M.FISMConfig(
            lambda_=args.lambda_, loss=loss, num_dim=args.num_dim,
            num_neg=args.num_neg, alpha=args.alpha,
            using_adagrad=args.adagrad, learn_rate=args.learn_rate,
            batch_size=max(args.batch_size // 8, 1),
        ))
    if method == "NEGMF":
        return M.NegMF(M.FactorModelConfig(
            lambda_=args.lambda_, loss=loss, num_dim=args.num_dim,
            num_neg=args.num_neg, using_adagrad=args.adagrad,
            learn_rate=args.learn_rate, batch_size=args.batch_size,
            dense_mode=(None if args.dense_mode == "auto"
                        else _booly(args.dense_mode)),
        ))
    if method in ("LINEAR", "FM"):
        if method == "LINEAR":
            return M.LinearModel(M.LinearModelConfig(
                lambda_=args.lambda_, loss=loss,
                using_adagrad=args.adagrad, learn_rate=args.learn_rate,
                batch_size=args.batch_size,
            ))
        return M.FactorModel(M.FactorModelConfig(
            lambda_=args.lambda_, loss=loss, num_dim=args.num_dim,
            using_adagrad=args.adagrad, learn_rate=args.learn_rate,
            batch_size=args.batch_size,
        ))
    if method == "CDAE":
        import jax.numpy as jnp

        dense = None if args.dense_mode == "auto" else _booly(args.dense_mode)
        return M.CDAE(M.CDAEConfig(
            lambda_=args.lambda_, learn_rate=args.learn_rate, loss=loss,
            num_dim=args.num_dim, using_adagrad=args.adagrad,
            corruption_ratio=args.cratio, num_corruptions=args.cnum,
            asymmetric=args.asym, user_factor=args.user_factor,
            linear=args.linear, num_neg=args.num_neg, scaled=args.scaled,
            beta=args.beta, linear_function=args.linear_function,
            tanh=args.tanh, batch_size=min(args.batch_size, 1024),
            dense_mode=dense,
            compute_dtype=jnp.bfloat16 if args.bf16_compute else None,
        ))
    raise SystemExit(f"unknown --method {args.method}")


def wrap_sharded(model, args):
    """--sharded dispatch: the mesh-parallel trainer for --method (the
    multi-chip layer the reference does not have, SURVEY §2e). Drop-in for
    Solver/Evaluation; mesh shape from --mesh_model (rest on 'data')."""
    from cdae_jax import models as M
    from cdae_jax.parallel import trainer as T
    from cdae_jax.parallel.mesh import make_mesh

    mesh = make_mesh(n_model=max(args.mesh_model, 1))
    if isinstance(model, M.CDAE):
        return T.ShardedCDAE(model.cfg, mesh=mesh)
    if isinstance(model, (M.BPR, M.WARP, M.IMF, M.PMF)):
        if args.shard_items:
            from cdae_jax.parallel.tp_pairwise import ShardedMFTP

            return ShardedMFTP(model, mesh=mesh)
        if isinstance(model, M.IMF) and _booly(args.dense_mode):
            return T.ShardedIMF(model.cfg, mesh=mesh)  # dense (U,I) slabs
        return T.ShardedPairwise(model, mesh=mesh)
    if isinstance(model, M.WRMF):  # before ALS: WRMF subclasses it
        return T.ShardedWRMF(model.cfg, mesh=mesh)
    if isinstance(model, M.ALS):
        return T.ShardedALS(model.cfg, mesh=mesh)
    if isinstance(model, M.FISMPair):
        raise SystemExit("--sharded does not cover FISMPAIR (pointwise "
                         "ShardedFISM only); train it single-chip")
    if isinstance(model, M.FISM):
        return T.ShardedFISM(model.cfg, mesh=mesh)
    if isinstance(model, M.NegMF):
        return T.ShardedNegMF(model, mesh=mesh)
    raise SystemExit(f"--sharded not supported for --method {args.method}")


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


def run(argv: Optional[List[str]] = None):
    """Run one CLI task; returns the Solver of a train/test task (its
    ``state`` and ``history`` hold the outcome), else None."""
    args = build_arg_parser().parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from cdae_jax.utils.compile_cache import enable as _enable_cache

    _enable_cache()  # persistent XLA compile cache
    eval_types = [e.strip() for e in args.eval.split(",") if e.strip()]
    if args.rel_threshold != 4.0:
        from cdae_jax.evaluation import Evaluation
        eval_types = [
            Evaluation.create(e, rel_threshold=args.rel_threshold)
            if e.upper() == "RANKING" else e
            for e in eval_types
        ]

    if args.task == "prepare":
        data = Interactions.from_text(args.input_file, PARSERS[args.parser],
                                      num_threads=args.num_thread)
        logger.info("loaded %s", data)
        data_io.save_interactions(data, args.cache_file)
        logger.info("cached -> %s", args.cache_file)
        return None

    if args.task == "split":
        data = data_io.load_interactions(args.cache_file)
        logger.info("loaded %s", data)
        train, test = data.split_by_user(args.test_ratio, seed=args.seed)
        logger.info("train %s / test %s", train, test)
        data_io.save_interactions(train, args.train_cache_file)
        data_io.save_interactions(test, args.test_cache_file)
        return None

    if args.task == "sweep":
        # the reference's qsub grid (apps/yelp/cdae.sh) as one sequential run
        from cdae_jax.sweep import run_sweep

        data = data_io.load_interactions(args.cache_file)
        logger.info("loaded %s", data)
        train, test = data.split_by_user(args.test_ratio, seed=args.seed)
        run_sweep(train, test, iters=args.max_iters,
                  batch_size=args.batch_size, seed=args.seed,
                  limit=args.sweep_limit)
        return None

    # train/test tasks need the splits (the reference's intended — not
    # shipped — control flow, see module docstring)
    if args.task == "train":
        data = data_io.load_interactions(args.cache_file)
        logger.info("loaded %s", data)
        train, test = data.split_by_user(args.test_ratio, seed=args.seed)
    else:  # test
        train = data_io.load_interactions(args.train_cache_file)
        test = data_io.load_interactions(args.test_cache_file)
    logger.info("train %s / test %s", train, test)

    from cdae_jax.models.fism import FISM
    from cdae_jax.models.linear import LinearModel
    from cdae_jax.solver.solver import SGDSolver, Solver
    from cdae_jax.utils import checkpoint as ckpt

    # the reference app always trains + evaluates Popularity first
    # (yelp.cpp:110-113)
    if not args.skip_popularity and args.task == "train":
        from cdae_jax.models.popularity import Popularity

        pop = Solver(Popularity(), max_iteration=1, seed=args.seed)
        pop.train(train, test, ["TOPN"])

    if args.method.upper() == "NONE":
        return None

    model = build_model(args)
    solver_cls = (
        SGDSolver if isinstance(model, (FISM, LinearModel)) else Solver
    )
    if args.sharded:
        model = wrap_sharded(model, args)
    solver = solver_cls(model, max_iteration=args.max_iters,
                        eval_iterations=args.eval_iters, seed=args.seed,
                        trace_dir=args.trace_dir or None,
                        guard=args.guard_nan,
                        loss_sample_size=args.loss_sample)
    if isinstance(solver, SGDSolver):
        solver.learn_rate0 = args.learn_rate

    if args.task == "train":
        solver.train(
            train, test, eval_types,
            resume_from=args.init_checkpoint or None,
            checkpoint_path=args.checkpoint or None,
            checkpoint_every=args.checkpoint_every,
        )
        if args.checkpoint:
            logger.info("checkpoint -> %s", args.checkpoint)
    else:
        solver.state = model.reset(train, seed=args.seed)
        if args.init_checkpoint:
            ckpt.load_checkpoint(args.init_checkpoint, solver.state)
        solver.test(test, eval_types, train_data=train)
    return solver


if __name__ == "__main__":
    sys.exit(main())
