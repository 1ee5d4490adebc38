#!/usr/bin/env python
"""Device times of the plain XLA paths on the main CDAE path, at the bench
shapes (U=6040, I=3706, D=50; dense step batch 1536, eval batch 1024) and
at the huge-catalog serving shape (B=256, I=1M, D=50).

These are the numbers a hand-written kernel for any of them has to beat:
  dense_step      the XLA dense train step (corruption + negative masks
                  from jax.random, encode, decode, grads, AdaGrad)
  rng_masks       the step's two (B, I) jax.random.uniform draws alone
  dense_scores    CDAE TOPN scoring from the resident interaction rows
  batch_scores    CDAE TOPN scoring from padded rated rows
  streaming_topk  blockwise decode + top-10 with rated exclusion
  full_topk       the same from a full (B, I) score matrix

Each line is JSON with the mean device time per call (host clock around
``reps`` back-to-back calls ending in block_until_ready). With
``--trace_dir`` a jax.profiler trace of one fused 3-epoch training program
(``CDAE.train_epochs``, the bench path) is written there and its device
events are summed by name (top ops, busy share of the program's window).

Usage: python scripts/time_xla_paths.py [--trace_dir DIR] [--reps N]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timed(fn, args, reps, thread=None):
    """Mean seconds per call over ``reps`` queued calls (after 3 warm
    calls). ``thread`` maps a call's output to the next call's args."""
    import jax

    out = None
    for _ in range(3):
        out = fn(*args)
        if thread:
            args = thread(out, args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        if thread:
            args = thread(out, args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, args


def trace_summary(trace_dir: str, top: int = 15) -> dict:
    """Sum device-plane event durations by name; busy = union of event
    intervals over the device plane's lines, within the traced window."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    pd = ProfileData.from_file(path)
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            by_name = defaultdict(int)
            spans = []
            for e in line.events:
                by_name[e.name] += e.duration_ns
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
            if not spans:
                continue
            spans.sort()
            busy, end = 0, spans[0][0]
            for s, e in spans:
                if e > end:
                    busy += e - max(s, end)
                    end = e
            window = spans[-1][1] - spans[0][0]
            total = sum(by_name.values())
            out[f"{plane.name} | {line.name}"] = {
                "events": len(spans),
                "window_ms": window / 1e6,
                "busy_share": busy / window if window else 0.0,
                "top": [(n, d / 1e6, d / total if total else 0.0)
                        for n, d in sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:top]],
            }
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace_dir", default="")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import gpu_name_and_power_limit, synthetic_interactions
    from cdae_jax.models.cdae import (
        CDAE, CDAEConfig, _batch_scores, _dense_scores)
    from cdae_jax.ops.topk import streaming_topk_scores, topk_unrated

    dev = jax.devices()[0]
    meta = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "gpu": gpu_name_and_power_limit()}

    def emit(name, seconds, **kw):
        print(json.dumps({"op": name, "ms_per_call": seconds * 1e3, **kw,
                          **meta}), flush=True)

    U, I, D, B_TRAIN, B_EVAL = 6040, 3706, 50, 1536, 1024
    data = synthetic_interactions(U, I, 160)
    model = CDAE(CDAEConfig(num_dim=D, loss="SQUARE", corruption_ratio=0.5,
                            scaled=True, num_neg=5, batch_size=B_TRAIN))
    state = model.reset(data, seed=0)
    R = state.aux["dense_R"]
    uid_mat, w_mat = model._dense_batches(state)
    uids, w = uid_mat[0], w_mat[0]

    def step_thread(out, a):
        return (out,) + a[1:]

    for prec in ("default", "highest"):
        ctx = jax.default_matmul_precision(prec)
        with ctx:
            params = jax.tree.map(jnp.copy, state.params)
            dt, _ = timed(model._dense_step,
                          (params, R, uids, w, jax.random.PRNGKey(1)),
                          args.reps, thread=step_thread)
        emit("dense_step", dt, precision=prec, B=B_TRAIN, I=I, D=D)

    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    rng2 = jax.jit(lambda a, b: (jax.random.uniform(a, (B_TRAIN, I)),
                                 jax.random.uniform(b, (B_TRAIN, I))))
    dt, _ = timed(rng2, (k1, k2), args.reps)
    emit("rng_masks", dt, B=B_TRAIN, I=I, draws=2)

    eval_uids = jnp.arange(B_EVAL, dtype=jnp.int32)
    ri = jnp.asarray(state.padded.items[:B_EVAL])
    rm = jnp.asarray(state.padded.mask[:B_EVAL])
    dense_sc = jax.jit(lambda p, r, u: _dense_scores(p, r, u, cfg=model.cfg))
    sparse_sc = jax.jit(lambda p, u, a, m: _batch_scores(p, u, a, m,
                                                         cfg=model.cfg))
    dt, _ = timed(dense_sc, (state.params, R, eval_uids), args.reps)
    emit("dense_scores", dt, B=B_EVAL, I=I, D=D)
    dt, _ = timed(sparse_sc, (state.params, eval_uids, ri, rm), args.reps)
    emit("batch_scores", dt, B=B_EVAL, I=I, D=D, L=int(ri.shape[1]))

    rng = np.random.default_rng(3)
    Bt, It = 256, 1_000_000
    s = 4.0 * np.sqrt(6.0 / (It + D))
    z = jnp.asarray(rng.uniform(0, 1, (Bt, D)), jnp.float32)
    W = jnp.asarray(rng.uniform(-s, s, (It, D)), jnp.float32)
    bp = jnp.asarray(rng.normal(0, 0.01, It), jnp.float32)
    lengths = np.minimum((rng.pareto(1.2, Bt) * 20).astype(int) + 1, 4000)
    rated = np.full((Bt, int(lengths.max())), It, np.int32)
    for b, n in enumerate(lengths):
        ids = np.unique(rng.integers(0, It, n))
        rated[b, :len(ids)] = ids
    rated = jnp.asarray(rated)
    dt, _ = timed(lambda *a: streaming_topk_scores(*a, k=10),
                  (z, W, bp, rated), max(args.reps // 5, 5))
    emit("streaming_topk", dt, B=Bt, I=It, D=D, L=int(rated.shape[1]))
    full = jax.jit(lambda z, W, bp, r: topk_unrated(z @ W.T + bp[None, :],
                                                    r, 10))
    dt, _ = timed(full, (z, W, bp, rated), max(args.reps // 5, 5))
    emit("full_topk", dt, B=Bt, I=It, D=D, L=int(rated.shape[1]))

    if args.trace_dir:
        epochs = 3
        key = jax.random.PRNGKey(4)
        state = model.train_epochs(state, epochs, key)  # compile
        jax.block_until_ready(state.params)
        jax.profiler.start_trace(args.trace_dir)
        state = model.train_epochs(state, epochs, key)
        jax.block_until_ready(state.params)
        jax.profiler.stop_trace()
        print(json.dumps({"trace": trace_summary(args.trace_dir),
                          "steps": epochs * int(uid_mat.shape[0]), **meta}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
