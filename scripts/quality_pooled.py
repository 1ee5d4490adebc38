"""Pooled-negative quality cell at a LARGE catalog (VERDICT r4 #2).

The only pooled-vs-exact oracle cell so far was the 2000u x 800i WORST-case
harness; this records the regime where pooled sampling is the default:
200k users x 50k items (config-5-shaped, heavy-tailed degrees). Both arms
run the SAME sparse CDAE step — exact complement sampling vs
neg_pool — at equal epochs AND at 2x epochs for the pooled arm (the
documented slab-cadence style compensation), reporting recall@10/MAP@10
on a fixed 20k-user validation subsample.

Run from /root/repo:  python scripts/quality_pooled.py
(~10 min on the chip; --users/--items/--epochs to shrink)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def gumbel_lowrank(num_users, num_items, avg_degree, rank=8, seed=20141119):
    """Vectorized low-rank + Zipf generator (Gumbel top-n per user) — the
    per-user rng.choice of data/synthetic.py is too slow past ~10k users."""
    import numpy as np

    from cdae_jax.data.dataset import Interactions

    rng = np.random.default_rng(seed)
    uf = rng.standard_normal((num_users, rank)).astype(np.float32)
    vf = rng.standard_normal((num_items, rank)).astype(np.float32)
    pop = 1.0 / np.arange(1, num_items + 1) ** 1.0
    rng.shuffle(pop)
    log_pop = np.log(pop / pop.sum()).astype(np.float32)
    sizes = np.minimum(
        1 + rng.geometric(1.0 / avg_degree, size=num_users), num_items // 2
    )
    users_out, items_out = [], []
    block = 1024
    for start in range(0, num_users, block):
        end = min(start + block, num_users)
        logits = uf[start:end] @ vf.T / np.sqrt(rank) + log_pop[None, :]
        logits = 2.0 * logits + rng.gumbel(size=logits.shape).astype(
            np.float32
        )
        kmax = int(sizes[start:end].max())
        top = np.argpartition(-logits, kmax - 1, axis=1)[:, :kmax]
        for row in range(end - start):
            n = sizes[start + row]
            users_out.append(np.full(n, start + row, np.int32))
            items_out.append(np.sort(top[row, :n]).astype(np.int32))
    users = np.concatenate(users_out)
    items = np.concatenate(items_out)
    return Interactions.from_arrays(
        users, items, np.ones(len(users), np.float32),
        num_users=num_users, num_items=num_items,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=200_000)
    ap.add_argument("--items", type=int, default=50_000)
    ap.add_argument("--degree", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--neg_pool", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--val_users", type=int, default=20_000)
    ap.add_argument("--batch_size", type=int, default=1024)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from cdae_jax.data.dataset import Interactions
    from cdae_jax.evaluation import Evaluation
    from cdae_jax.models.cdae import CDAE, CDAEConfig

    t0 = time.time()
    data = gumbel_lowrank(args.users, args.items, args.degree)
    train, val = data.split_by_user(0.2, seed=20141119)
    print(f"# data {data} in {time.time()-t0:.0f}s", file=sys.stderr)
    # fixed validation subsample (eval over all 200k users would dwarf
    # training time; the subsample is identical across arms)
    keep = val.users < args.val_users
    val_sub = Interactions.from_arrays(
        val.users[keep], val.items[keep], val.ratings[keep],
        num_users=args.users, num_items=args.items,
    )
    ev = Evaluation.create("TOPN", batch_size=args.batch_size)

    def run(neg_pool, epochs, tag):
        cfg = CDAEConfig(
            num_dim=args.dim, loss="SQUARE", corruption_ratio=0.5,
            scaled=True, num_neg=5, user_factor=True,
            batch_size=args.batch_size, stream_batches=True,
            dense_mode=False, neg_pool=neg_pool,
        )
        model = CDAE(cfg)
        state = model.reset(train, seed=0)
        key = jax.random.PRNGKey(7)
        t1 = time.time()
        for e in range(epochs):
            state = model.train_one_iteration(state, jax.random.fold_in(key, e))
            float(jnp.sum(state.params["W"]))  # bound queued work per epoch
        dt = time.time() - t1
        m = ev.evaluate(model, state, val_sub, train)
        out = {"tag": tag, "neg_pool": neg_pool or 0, "epochs": epochs,
               "train_s": round(dt, 1),
               "users_per_s": round(args.users * epochs / dt),
               "recall_at_10": round(m["R@10"], 5),
               "map_at_10": round(m["MAP@10"], 5)}
        print(json.dumps(out))
        return out

    exact = run(None, args.epochs, "exact")
    pooled = run(args.neg_pool, args.epochs, "pooled_equal_epochs")
    pooled2 = run(args.neg_pool, 2 * args.epochs, "pooled_2x_epochs")
    print(json.dumps({
        "cell": f"{args.users}x{args.items} deg{args.degree} D{args.dim}",
        "delta_equal_epochs": round(
            pooled["recall_at_10"] - exact["recall_at_10"], 5),
        "delta_2x_epochs": round(
            pooled2["recall_at_10"] - exact["recall_at_10"], 5),
    }))


if __name__ == "__main__":
    sys.exit(main())
