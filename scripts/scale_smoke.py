#!/usr/bin/env python
"""Scale smoke toward BASELINE.json config 5 (10M users / 1M items).

Single-chip slice of the sharded design: CSR streaming batches (no padded
matrix), sparse train steps over the 1M-item table, and streaming blockwise
top-k eval (no (B, I) score materialization). Runs a PARTIAL epoch (the full
10M-user epoch belongs on a multi-device mesh) and prints measured rates.

Usage: python scripts/scale_smoke.py [--users 10000000 --items 1000000]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from cdae_jax.utils.compile_cache import enable as _enable_cache

_enable_cache()  # persistent XLA compile cache


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=10_000_000)
    ap.add_argument("--items", type=int, default=1_000_000)
    ap.add_argument("--degree", type=int, default=50)
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=4096,
                    help="MAX batch size; with --slots the per-bucket "
                         "size adapts to the token budget")
    ap.add_argument("--train_batches", type=int, default=30)
    ap.add_argument("--slots", type=int, default=262144,
                    help="token-budget batching: per-bucket batch size "
                         "fits B*L to this budget (0 = fixed batch_size; "
                         "fixed bs4096 on the L=1024 bucket needs ~840 MB "
                         "per gradient temporary)")
    ap.add_argument("--eval_batches", type=int, default=3)
    ap.add_argument("--neg_pool", type=int, default=0,
                    help="pooled negatives (CDAEConfig.neg_pool); 0 = exact")
    ap.add_argument("--row_update", default="auto",
                    help="CDAEConfig.row_update: auto|true|false "
                         "(touched-rows delta AdaGrad; auto = on past "
                         "~128k items)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import synthetic_interactions
    from cdae_jax.models.base import (
        count_user_batches_csr,
        iter_user_batches_csr,
    )
    from cdae_jax.models.cdae import CDAE, CDAEConfig

    t0 = time.perf_counter()
    data = synthetic_interactions(args.users, args.items, args.degree)
    print(f"# generated {data} in {time.perf_counter()-t0:.0f}s",
          file=sys.stderr)

    model = CDAE(CDAEConfig(
        num_dim=args.dim, loss="SQUARE", corruption_ratio=0.5, scaled=True,
        num_neg=5, user_factor=True, batch_size=args.batch_size,
        cache_device_batches=False,
        neg_pool=args.neg_pool or None,
        row_update=(None if args.row_update == "auto"
                    else args.row_update.lower() in ("1", "true", "yes")),
    ))
    t0 = time.perf_counter()
    state = model.reset(data, seed=0)
    print(f"# reset in {time.perf_counter()-t0:.0f}s "
          f"(streaming={state.padded is None}, "
          f"dense={'dense_R' in state.aux})", file=sys.stderr)

    key = jax.random.PRNGKey(0)
    params = state.params
    # STRATIFIED batch sample: iter_user_batches_csr sorts users by row
    # length, so "the first N batches" are the dataset's SHORTEST users —
    # a bias that grows with user count. Taking every (total/N)-th batch across the sorted order makes
    # the timed mix match the true epoch mix of length buckets.
    total_b = count_user_batches_csr(
        state.aux["csr"], args.batch_size,
        slots_per_batch=args.slots or None,
    )
    n_timed = min(args.train_batches, total_b)
    keep = set(np.linspace(0, total_b - 1, n_timed).round().astype(int))
    batches = [
        tuple(jnp.asarray(x) for x in (b.uids, b.items, b.mask,
                                       b.lengths, b.weight))
        for i, b in enumerate(iter_user_batches_csr(
            state.aux["csr"], state.num_items, args.batch_size,
            slots_per_batch=args.slots or None,
        ))
        if i in keep
    ]
    shapes = sorted({tuple(b[1].shape) for b in batches})
    print(f"# {len(batches)} timed batches spread over {total_b} "
          f"(length-stratified incl. tail), shapes {shapes}",
          file=sys.stderr)
    # warm pass: length-bucketed batches have MANY distinct (B, L) shapes
    # and each one compiles its own program, so timing the first pass
    # would measure mostly COMPILATION. Real multi-epoch training
    # amortizes the per-bucket compiles exactly like this warm pass does.
    for d in batches:
        key, sub = jax.random.split(key)
        params = model._train_step(params, *d, sub)
    jax.block_until_ready(params)
    done = int(sum(float(np.asarray(d[4]).sum()) for d in batches))
    t0 = time.perf_counter()
    for d in batches:
        key, sub = jax.random.split(key)
        params = model._train_step(params, *d, sub)
    jax.block_until_ready(params)
    train_dt = time.perf_counter() - t0
    state.params = params
    print(f"# trained {done} users over the {args.items}-item table in "
          f"{train_dt:.1f}s (post-compile) = {done/max(train_dt,1e-9):,.0f} "
          f"users/s", file=sys.stderr)

    # streaming top-k eval over the full 1M-item catalog. Timing protocol
    # matches the training loop: (1) host-side batch prep OUTSIDE the
    # timed region, (2) a warm pass compiles every distinct (B, L)
    # program, (3) the timed loop queues all batches and waits once.
    B = 1024
    prep = []
    for j in range(args.eval_batches):
        uids = np.arange(j * B, (j + 1) * B)
        ri, rm = model._user_rows(state, uids)
        prep.append((jnp.asarray(uids), jnp.asarray(ri), jnp.asarray(rm)))

    # the production CDAE.batch_topk program: hidden encode + mask +
    # blockwise top-k as ONE jitted program
    import functools

    from cdae_jax.models.cdae import _batch_topk_impl

    ev = jax.jit(functools.partial(_batch_topk_impl, cfg=model.cfg, k=10))
    for u, ri, rm in prep:  # warm: compile each (B, L) bucket program
        ids = ev(state.params, u, ri, rm)
    jax.block_until_ready(ids)
    t0 = time.perf_counter()
    for u, ri, rm in prep:
        ids = ev(state.params, u, ri, rm)
    jax.block_until_ready(ids)
    eval_dt = time.perf_counter() - t0
    n_eval = B * len(prep)
    print(f"# streaming top-10 over {args.items} items: "
          f"{n_eval/max(eval_dt,1e-9):,.0f} users/s "
          f"({n_eval} users in {eval_dt:.2f}s post-compile, "
          f"{n_eval*args.items/max(eval_dt,1e-9)/1e9:.1f}B scorings/s)",
          file=sys.stderr)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
