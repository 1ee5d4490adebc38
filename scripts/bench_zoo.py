"""Model-zoo throughput bench (users/s on the accelerator).

Measures the MF family on the same ML-1M-scale synthetic workload as the
C++ oracle's `bench_mf` mode (csrc/baseline_cdae.cpp), so the two sets of
numbers are directly comparable (VERDICT round-1 items 1 & 3).

usage: python scripts/bench_zoo.py [BPR WARP IMF ...] [--dim N] [--batch N]
       [--scatter auto|matmul|scatter] [--seconds S]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic(num_users, num_items, avg_degree, seed=20141119):
    from cdae_jax.data.dataset import Interactions

    rng = np.random.default_rng(seed)
    degrees = np.minimum(
        1 + rng.geometric(1.0 / avg_degree, size=num_users), num_items - 1
    )
    users = np.repeat(np.arange(num_users, dtype=np.int64), degrees)
    items = rng.integers(0, num_items, size=len(users))
    pairs = np.unique(users * num_items + items)
    return Interactions.from_arrays(
        (pairs // num_items).astype(np.int32),
        (pairs % num_items).astype(np.int32),
        num_users=num_users, num_items=num_items,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("models", nargs="*", default=["BPR"])
    ap.add_argument("--users", type=int, default=6040)
    ap.add_argument("--items", type=int, default=3706)
    ap.add_argument("--deg", type=int, default=160)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--scatter", default="auto")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--dense", action="store_true",
                    help="force the full-catalog dense-slab step")
    ap.add_argument("--sparse", action="store_true",
                    help="force the sparse path (disable auto-dense)")
    ap.add_argument("--row_update", action="store_true",
                    help="force touched-rows delta AdaGrad (auto >128k items)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="max scan steps per dispatch (MFConfig.epoch_chunk;"
                         " bounds each program at 1M-item scale)")
    ap.add_argument("--shared_neg", type=int, default=32,
                    help="BPR dense slab: shared negative draws per user "
                         "(MFConfig.num_shared_neg)")
    ap.add_argument("--warp_pool", type=int, default=None,
                    help="WARP: pooled candidate negatives of this size "
                         "(MFConfig.warp_pool)")
    ap.add_argument("--no_bucket", action="store_true",
                    help="FISM: disable length-bucketed batches")
    args = ap.parse_args()
    if args.dense and args.sparse:
        raise SystemExit("--dense and --sparse are mutually exclusive")
    dense_mode = True if args.dense else (False if args.sparse else None)

    import jax
    import jax.numpy as jnp

    from cdae_jax.models import als as als_mod
    from cdae_jax.models import fism as fism_mod
    from cdae_jax.models import mf as mf_mod

    data = synthetic(args.users, args.items, args.deg)
    print(f"# data: {data.num_users}u x {data.num_items}i "
          f"{len(data.users)} interactions", file=sys.stderr)

    for name in (args.models or ["BPR"]):
        if name in ("BPR", "WARP", "IMF", "PMF"):
            cls = getattr(mf_mod, name)
            cfg = mf_mod.MFConfig(
                num_dim=args.dim, batch_size=args.batch,
                scatter_mode=args.scatter,
                dense_mode=dense_mode,
                epoch_chunk=args.chunk,
                row_update=True if args.row_update else None,
                num_shared_neg=args.shared_neg,
                warp_pool=args.warp_pool,
            )
            if name == "BPR":
                cfg = cfg.__class__(**{**cfg.__dict__, "loss": "LOG"})
            if name == "WARP":
                cfg = cfg.__class__(**{**cfg.__dict__, "loss": "HINGE",
                                       "beta": 0.0, "lambda_": 0.1})
            model = cls(cfg)
        elif name == "FISM":
            model = fism_mod.FISM(fism_mod.FISMConfig(
                num_dim=args.dim, batch_size=args.batch,
                scatter_mode=args.scatter, dense_mode=dense_mode,
                bucket_by_length=not args.no_bucket))
        elif name == "NegMF":
            from cdae_jax.models.linear import FactorModelConfig, NegMF
            model = NegMF(FactorModelConfig(
                num_dim=args.dim, batch_size=args.batch, loss="LOG",
                dense_mode=dense_mode,
                using_global_mean=False))
        else:
            raise SystemExit(f"unknown model {name}")

        state = model.reset(data, seed=0)
        key = jax.random.PRNGKey(0)

        # warmup (compile) + single-epoch probe for the sync cadence
        key, sub = jax.random.split(key)
        state = model.train_one_iteration(state, sub)
        jax.block_until_ready(state.params)
        tp = time.perf_counter()
        key, sub = jax.random.split(key)
        state = model.train_one_iteration(state, sub)
        jax.block_until_ready(state.params)
        ep_probe = time.perf_counter() - tp
        # queue ~0.5 s of epochs between host syncs so dispatches can't
        # pile up unboundedly
        chunk = max(1, min(20, int(0.5 / max(ep_probe, 1e-3))))

        t0 = time.perf_counter()
        epochs = 0
        while time.perf_counter() - t0 < args.seconds and epochs < 1000:
            for _ in range(chunk):
                key, sub = jax.random.split(key)
                state = model.train_one_iteration(state, sub)
            jax.block_until_ready(state.params)
            epochs += chunk
        dt = time.perf_counter() - t0
        print(json.dumps({
            "model": name, "users_per_sec": round(args.users * epochs / dt, 1),
            "epochs": epochs, "elapsed_s": round(dt, 2), "dim": args.dim,
            "batch": args.batch, "scatter": args.scatter,
            "path": ("dense" if (
                "dense_R" in state.aux or "rated_mask" in state.aux
            ) else "sparse"),
        }))


if __name__ == "__main__":
    main()
