"""End-to-end Solver showcase at config-5 scale (1M users x 1M items):
the production path a reference user would actually run — prepare ->
split -> Solver.train with TOPN eval cadence — with every huge-catalog
mechanism engaged at once: CSR streaming batches, pooled negatives,
packed IO, and the streaming top-k behind the evaluator's batch_topk
preference.

Run from the repo root on the accelerator:  python scripts/solver_config5.py
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cdae_jax.utils.compile_cache import enable as _enable_cache

_enable_cache()  # persistent XLA compile cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=1_000_000)
    ap.add_argument("--items", type=int, default=1_000_000)
    ap.add_argument("--degree", type=int, default=50)
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--neg_pool", type=int, default=8192)
    ap.add_argument("--val_users", type=int, default=100_000,
                    help="evaluate this many users (0 = all; the eval is "
                    "O(val users); 100k keeps the showcase ~2 min)")
    args = ap.parse_args()

    from bench import synthetic_interactions
    from cdae_jax.data.dataset import Interactions
    from cdae_jax.models.cdae import CDAE, CDAEConfig
    from cdae_jax.solver.solver import Solver

    t0 = time.time()
    data = synthetic_interactions(args.users, args.items, args.degree)
    train, val = data.split_by_user(0.2, seed=20141119)
    if args.val_users:
        keep = val.users < args.val_users
        val = Interactions.from_arrays(
            val.users[keep], val.items[keep], val.ratings[keep],
            num_users=args.users, num_items=args.items)
    print(f"# {data} (val: {len(val)} pairs) in {time.time()-t0:.0f}s",
          file=sys.stderr)

    model = CDAE(CDAEConfig(
        num_dim=args.dim, loss="SQUARE", corruption_ratio=0.5, scaled=True,
        num_neg=5, user_factor=True, batch_size=4096,
        stream_batches=True, dense_mode=False, neg_pool=args.neg_pool,
    ))
    solver = Solver(model, max_iteration=args.iters,
                    eval_iterations=args.iters, seed=0, verbose=True)
    t0 = time.time()
    solver.train(train, val, ["TOPN"])
    h = solver.history[-1]
    print(f"# Solver config-5 showcase: {args.iters} iters + eval in "
          f"{time.time()-t0:.0f}s; R@10={h['R@10']:.4f} "
          f"TestTime={h['TestTime']:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
