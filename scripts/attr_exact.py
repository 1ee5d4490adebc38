"""Attribute the exact-complement sparse CDAE step's throughput floor at
the config-5 shape (VERDICT r4 #2b): which component keeps exact sampling
~4x behind pooled — the sampler, the row IO, or the AdaGrad table sweep?

Method: time, on the SAME stratified (B, L) batches over a 1M-item table,
  full        — the production exact step (packed_io)
  no_corrupt  — corruption_ratio=0 (removes the (B, L) corrupt draw)
  pooled      — neg_pool=8192 (the fast arm; replaces the per-user exact
                draws AND shrinks the negative row IO to the shared pool)
  row_update  — touched-rows delta AdaGrad (removes the dense table sweep)
  sampler     — ops/sampling.sample_unrated alone at the step's shapes
  gather      — the packed [W|b'] row gather alone (encoder-side IO)

Timing: warm each program, queue reps, ONE forced readback (CLAUDE.md).
Run from /root/repo: python scripts/attr_exact.py
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=300_000)
    ap.add_argument("--items", type=int, default=1_000_000)
    ap.add_argument("--degree", type=int, default=50)
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import synthetic_interactions
    from cdae_jax.models.base import iter_user_batches_csr
    from cdae_jax.models.cdae import CDAE, CDAEConfig
    from cdae_jax.ops import sampling

    data = synthetic_interactions(args.users, args.items, args.degree)
    print(f"# {data}", file=sys.stderr)

    base = dict(num_dim=args.dim, loss="SQUARE", corruption_ratio=0.5,
                scaled=True, num_neg=5, user_factor=True,
                batch_size=args.batch_size, stream_batches=True,
                dense_mode=False)
    model = CDAE(CDAEConfig(**base))
    state = model.reset(data, seed=0)
    csr = state.aux["csr"]

    # stratified timed batches (shortest-head bias is the round-4 lesson):
    # one batch from each quartile of the length-sorted stream incl. tail
    batches = list(iter_user_batches_csr(csr, args.items, args.batch_size))
    sel = [batches[i] for i in
           sorted({0, len(batches) // 2, 3 * len(batches) // 4,
                   len(batches) - 1})]
    shapes = [tuple(b.items.shape) for b in sel]
    print(f"# timed shapes {shapes} of {len(batches)} batches",
          file=sys.stderr)
    dev = [tuple(jnp.asarray(x) for x in
                 (b.uids, b.items, b.mask, b.lengths, b.weight))
           for b in sel]
    nuse = sum(int(np.sum(b.weight > 0)) for b in sel)

    def time_variant(tag, cfg):
        m = CDAE(cfg)
        s = m.reset(data, seed=0)
        key = jax.random.PRNGKey(1)
        for b in dev:  # warm every shape
            s.params = m._train_step(s.params, *b, key)
        float(jnp.sum(s.params["W"]))
        t0 = time.perf_counter()
        for r in range(args.reps):
            for b in dev:
                s.params = m._train_step(s.params, *b,
                                         jax.random.fold_in(key, r))
        float(jnp.sum(s.params["W"]))
        dt = (time.perf_counter() - t0) / args.reps
        print(f"{tag:12s} {dt*1e3:8.1f} ms/pass  "
              f"{nuse/dt:10,.0f} users/s")
        return dt

    full = time_variant("full", CDAEConfig(**base))
    time_variant("no_corrupt", CDAEConfig(**{**base,
                                             "corruption_ratio": 0.0}))
    time_variant("pooled", CDAEConfig(**base, neg_pool=8192))
    time_variant("row_update", CDAEConfig(**base, row_update=True))

    # component microbenches at the same shapes
    n_neg = 5

    @functools.partial(jax.jit, static_argnames=("n",))
    def draw(key, items, lengths, n):
        return sampling.sample_unrated(key, items, lengths, args.items,
                                       n * items.shape[1])

    key = jax.random.PRNGKey(2)
    for b in dev:
        draw(key, b[1], b[3], n_neg)
    out = None
    t0 = time.perf_counter()
    for r in range(args.reps):
        for b in dev:
            out = draw(jax.random.fold_in(key, r), b[1], b[3], n_neg)
    float(jnp.sum(out))
    dt = (time.perf_counter() - t0) / args.reps
    print(f"{'sampler':12s} {dt*1e3:8.1f} ms/pass  (num_neg*L draws/user)")

    W = state.params["W"]

    @jax.jit
    def gather(items):
        return jnp.sum(W[jnp.clip(items, 0, args.items - 1)])

    for b in dev:
        gather(b[1])
    t0 = time.perf_counter()
    for r in range(args.reps):
        for b in dev:
            out = gather(b[1])
    float(out)
    dt = (time.perf_counter() - t0) / args.reps
    print(f"{'gather':12s} {dt*1e3:8.1f} ms/pass  (encoder row IO, unpacked)")


if __name__ == "__main__":
    sys.exit(main())
