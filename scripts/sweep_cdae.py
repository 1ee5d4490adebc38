#!/usr/bin/env python
"""CDAE hyperparameter sweep — the reference's qsub grid, on one device.

Enumerates the WSDM'16 paper grid exactly as the reference sweep script
(ref apps/yelp/cdae.sh:3-36: scale x user_factor x cratio{0..1} x linear x
asym x loss{SQUARE,CE}, lr=0.1, dim=50, num_neg=5, beta=1, seed=20141119)
and trains every config sequentially with the fused-epoch path — what took a
cluster of qsub jobs fits one chip. Prints one JSON line per config.

Usage:
  python scripts/sweep_cdae.py --cache_file data.bin [--limit N] [--iters 50]
  python scripts/sweep_cdae.py --synthetic  # structured synthetic data
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache_file", default="")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--items", type=int, default=800)
    ap.add_argument("--degree", type=int, default=40)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=20141119)
    ap.add_argument("--limit", type=int, default=0,
                    help="run only N grid points from --offset (0 = all)")
    ap.add_argument("--offset", type=int, default=0,
                    help="skip the first N grid points (parallel sharding)")
    ap.add_argument("--platform", default="",
                    help="force a jax platform (e.g. 'cpu'); the container "
                         "pins jax_platforms so the env var alone is ignored")
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from cdae_jax.data import io as data_io
    from cdae_jax.sweep import run_sweep

    if args.synthetic or not args.cache_file:
        from cdae_jax.data.synthetic import lowrank_interactions

        data = lowrank_interactions(args.users, args.items, args.degree,
                                    seed=args.seed)
    else:
        data = data_io.load_interactions(args.cache_file)
    train, test = data.split_by_user(0.2, seed=args.seed)
    print(f"# {data} -> train {len(train)} / test {len(test)}",
          file=sys.stderr)
    run_sweep(train, test, iters=args.iters, batch_size=args.batch_size,
              seed=args.seed, limit=args.limit, offset=args.offset)
    return 0


if __name__ == "__main__":
    sys.exit(main())
