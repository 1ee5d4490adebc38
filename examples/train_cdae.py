#!/usr/bin/env python
"""End-to-end example: train CDAE on a MovieLens-format ratings file.

Usage:
  python examples/train_cdae.py [ratings.txt]     # defaults to the fixture

Mirrors the reference yelp pipeline (SURVEY.md §3.1): load -> per-user 80/20
split -> Popularity baseline -> CDAE with TOPN evaluation every 5 epochs.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cdae_jax.data.dataset import Interactions, movielens_line_parser
from cdae_jax.models import CDAE, CDAEConfig, Popularity
from cdae_jax.solver.solver import Solver


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", "sample_movielens.txt",
    )
    data = Interactions.from_text(path, movielens_line_parser)
    print(f"loaded {data}")
    train, test = data.split_by_user(0.2, seed=20141119)

    Solver(Popularity(), max_iteration=1).train(train, test, ["TOPN"])

    model = CDAE(CDAEConfig(
        num_dim=50, learn_rate=0.1, lambda_=0.01, loss="SQUARE",
        corruption_ratio=0.5, scaled=True, num_neg=5, user_factor=True,
        batch_size=64,
    ))
    Solver(model, max_iteration=30, eval_iterations=5).train(
        train, test, ["TOPN", "RANKING"]
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
