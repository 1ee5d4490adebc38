"""The reference's CDAE hyperparameter sweep as a library call.

The reference ships its one published experimental surface as a qsub grid
(ref apps/yelp/cdae.sh:3-36: SCALE x USER_FACTOR x RATIO{0,.2,..,1} x
LINEAR x ASYM x LOSS{SQUARE,CE}; lr=0.1, dim=50, num_neg=5, beta=1,
seed=20141119). Here the grid is a generator + a sequential runner on the
fused-epoch path — one chip replaces the cluster. Exposed both as
`scripts/sweep_cdae.py` and `cdae_jax.cli --task sweep`.
"""

from __future__ import annotations

import itertools
import json
import sys
from typing import Iterator, Optional, TextIO

PAPER_SEED = 20141119


def paper_grid() -> Iterator[dict]:
    """The exact loops of ref apps/yelp/cdae.sh:3-25, in script order."""
    for scale, uf, ratio, linear, asym, loss in itertools.product(
        (False, True),                    # SCALE
        (True, False),                    # USER_FACTOR
        (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),  # RATIO
        (False, True),                    # LINEAR
        (True, False),                    # ASYM
        ("SQUARE", "CE"),                 # LOSS
    ):
        yield dict(scaled=scale, user_factor=uf, cratio=ratio,
                   linear=linear, asym=asym, loss=loss)


def run_sweep(
    train,
    test,
    iters: int = 50,
    batch_size: int = 64,
    seed: int = PAPER_SEED,
    limit: int = 0,
    offset: int = 0,
    out: Optional[TextIO] = None,
) -> list:
    """Train + TOPN-evaluate every grid point; returns the result dicts
    (and streams one JSON line per config to ``out``, default stdout).
    ``offset``/``limit`` select a contiguous slice of the grid so the 192
    points can shard across parallel worker processes."""
    import jax

    from cdae_jax.evaluation import Evaluation
    from cdae_jax.models.cdae import CDAE, CDAEConfig

    out = sys.stdout if out is None else out
    ev = Evaluation.create("TOPN")
    results = []
    for n, g in enumerate(paper_grid()):
        if n < offset:
            continue
        if limit and n >= offset + limit:
            break
        cfg = CDAEConfig(
            learn_rate=0.1, num_dim=50, num_corruptions=1,
            corruption_ratio=g["cratio"], using_adagrad=True,
            asymmetric=g["asym"], linear=g["linear"], scaled=g["scaled"],
            user_factor=g["user_factor"], loss=g["loss"], beta=1.0,
            linear_function=False, tanh=False, num_neg=5, lambda_=0.01,
            batch_size=batch_size,
        )
        model = CDAE(cfg)
        state = model.reset(train, seed=seed)
        state = model.train_epochs(state, iters, jax.random.PRNGKey(seed))
        res = ev.evaluate(model, state, test, train)
        rec = dict(g, grid_index=n,
                   **{"R@10": round(res["R@10"], 5),
                      "MAP@10": round(res["MAP@10"], 5)})
        print(json.dumps(rec), file=out, flush=True)
        results.append(rec)
    return results
