#!/usr/bin/env python
"""Metric-parity harness: this CDAE vs the reference-semantics C++
implementation on an identical train/test split (BASELINE.md step 1-2).

Generates a structured synthetic dataset (low-rank + popularity skew),
splits per-user 80/20, trains BOTH implementations with the canonical
config, and reports recall@10 / MAP@10 side by side. Parity gate: this
build must be within --tolerance (absolute) of the C++ recall@10 or better.

Modes:
  python scripts/parity_cdae.py                 # single canonical config
  python scripts/parity_cdae.py --grid          # variant matrix over the
      canonical sweep axes (ref apps/yelp/cdae.sh:3-25 + cdae.hpp:13-31):
      corruption ratio x loss {SQUARE,CE} x user_factor x asymmetric V x
      tanh x per-user gate Uu (linear_function) x identity activation
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# Each grid cell: (name, C++ variant flags, CDAEConfig overrides)
GRID = [
    ("base", [], {}),
    ("loss=CE", ["loss=CE"], {"loss": "CE"}),
    ("asym", ["asym"], {"asymmetric": True}),
    ("tanh", ["tanh"], {"tanh": True}),
    ("lf(Uu)", ["lf"], {"linear_function": True}),
    ("no_user_factor", ["no_uf"], {"user_factor": False}),
    # identity activation and ratio=1.0 have no saturation / learn only from
    # bias+decoder — the batched-AdaGrad trajectory tracks the sequential
    # one only at small batch (measured: bs64 R@10 0.401/0.490 vs C++
    # 0.522/0.516; bs16 0.515/0.508 — within tolerance)
    ("linear_act", ["linear"], {"linear": True, "batch_size": 16}),
    ("CE+asym", ["loss=CE", "asym"], {"loss": "CE", "asymmetric": True}),
    ("CE+tanh", ["loss=CE", "tanh"], {"loss": "CE", "tanh": True}),
    ("cratio=0.0", [], {"corruption_ratio": 0.0}),
    ("cratio=0.8", [], {"corruption_ratio": 0.8}),
    ("cratio=1.0", [], {"corruption_ratio": 1.0, "batch_size": 16}),
    # pooled negatives (ROADMAP r2: the huge-catalog sparse-path sampling
    # rewrite) vs the reference's exact per-user complement sampling: same
    # expected touch count per unrated item, so the metric must match the
    # exact-sampling oracle at equal epochs. dense_mode off so the sparse
    # path (where neg_pool lives) actually runs.
    ("neg_pool=4096", [],
     {"neg_pool": 4096, "dense_mode": False}),
    # touched-rows delta AdaGrad (CDAEConfig.row_update — the huge-catalog
    # apply): per-contribution accumulator cadence instead of accumulate-
    # then-apply; gate vs the same exact-sampling oracle. The second cell
    # is the actual config-5 combination (row updates + pooled negatives).
    ("row_update", [],
     {"row_update": True, "dense_mode": False}),
    ("row_update+pool", [],
     {"row_update": True, "neg_pool": 4096, "dense_mode": False}),
]


def build_oracle():
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc", "baseline_cdae.cpp")
    exe = os.path.join(tempfile.gettempdir(), "baseline_cdae_parity")
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                    "-o", exe, src], check=True)
    return exe


def cpp_run(exe, tr_path, te_path, args, cratio, flags):
    out = subprocess.run(
        [exe, "parity", tr_path, te_path, str(args.iters), str(args.dim),
         str(cratio), str(args.num_neg), str(args.lr)] + flags,
        check=True, capture_output=True, text=True,
    ).stdout
    return json.loads(out)


def ours_run(train, test, args, overrides):
    # batched AdaGrad needs enough update steps per epoch to match the
    # sequential trajectory: batch 64 reaches reference parity at the same
    # epoch count (validated sweep: R@10 0.5545 vs C++ 0.5552 @ 25 epochs)
    import jax

    from cdae_jax.evaluation import Evaluation
    from cdae_jax.models.cdae import CDAE, CDAEConfig

    cfg = dict(
        num_dim=args.dim, learn_rate=args.lr, lambda_=0.01, loss="SQUARE",
        corruption_ratio=args.cratio, scaled=True, num_neg=args.num_neg,
        user_factor=True, batch_size=64,
    )
    cfg.update(overrides)
    model = CDAE(CDAEConfig(**cfg))
    state = model.reset(train, seed=args.seed)
    state = model.train_epochs(state, args.iters,
                               jax.random.PRNGKey(args.seed))
    return Evaluation.create("TOPN").evaluate(model, state, test, train)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--items", type=int, default=800)
    ap.add_argument("--degree", type=int, default=40)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--cratio", type=float, default=0.5)
    ap.add_argument("--num_neg", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--tolerance", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=20141119)
    ap.add_argument("--grid", action="store_true",
                    help="run the canonical variant matrix")
    ap.add_argument("--only", default=None,
                    help="comma-separated grid cell names to run")
    args = ap.parse_args()

    from cdae_jax.data.synthetic import lowrank_interactions, write_pairs

    data = lowrank_interactions(args.users, args.items, args.degree,
                                seed=args.seed)
    train, test = data.split_by_user(0.2, seed=args.seed)
    print(f"# data: {data}, train {len(train)}, test {len(test)}",
          file=sys.stderr)

    exe = build_oracle()
    cells = GRID if args.grid else [("base", [], {})]
    if args.only:
        names = set(args.only.split(","))
        cells = [c for c in cells if c[0] in names]

    results = []
    ok = True
    with tempfile.TemporaryDirectory() as td:
        tr_path = os.path.join(td, "train.txt")
        te_path = os.path.join(td, "test.txt")
        write_pairs(tr_path, train)
        write_pairs(te_path, test)
        for name, flags, overrides in cells:
            cratio = overrides.get("corruption_ratio", args.cratio)
            cpp = cpp_run(exe, tr_path, te_path, args, cratio, flags)
            ours = ours_run(train, test, args, overrides)
            delta = ours["R@10"] - cpp["recall_at_10"]
            cell = {
                "variant": name,
                "cpp_recall_at_10": cpp["recall_at_10"],
                "ours_recall_at_10": round(ours["R@10"], 5),
                "cpp_map_at_10": cpp["map_at_10"],
                "ours_map_at_10": round(ours["MAP@10"], 5),
                "delta_recall": round(delta, 5),
                "parity": bool(delta >= -args.tolerance),
            }
            ok &= cell["parity"]
            results.append(cell)
            print(json.dumps(cell))
            sys.stdout.flush()

    if args.grid:
        print(json.dumps({"cells": len(results), "all_parity": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
