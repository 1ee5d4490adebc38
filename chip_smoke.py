#!/usr/bin/env python
"""Smoke test of the main path on the GPU, through the user entry points.

    python chip_smoke.py           # one card: device, train, compare
    python chip_smoke.py --multi   # four cards: the sharded CDAE path only

Phases (one process; any failed check exits non-zero):

  device   nvidia-smi's card name and power limit, jax.devices(); a
           platform other than "gpu" is an error, never a CPU fallback.
  train    the CLI (cdae_jax.cli) on a synthetic ML-1M-shaped set (6040
           users x 3706 items, geometric degrees, mean 160): prepare, then
           CDAE at D=50 trained 3 iterations with TOPN eval, once in dense
           mode (auto-selected) and once in the sparse exact-complement
           formulation. Params must be finite and R@10 > 0.
  compare  at the timed widths (B=1024, I=3706, D=50, U=6040): the dense
           step against the independent sparse step, and batch scores
           against the same scores, under matmul precision "highest";
           then the huge-catalog streaming top-k (B=256, I=1M, D=50,
           heavy-tailed rated rows) against a full masked score matrix.
  multi    (--multi) dense ShardedCDAE on a 2x2 ('data', 'model') mesh
           against single-device CDAE: params after one step, then sharded
           scores + distributed top-k after a few steps.

Tolerances. Under "highest" every f32 product is exact, so the two
formulations differ only by summation order: arrays match to rtol 1e-4
plus atol 1e-5 + 3e-4 x max|ref|. The atol term covers entries that are
long sums with cancellation: a hidden gradient sums up to 3706 terms
whose magnitudes add to ~40x the result, so its f32 rounding (~sqrt(n)
ulps of the terms) reaches ~1e-4 of the array's largest entry (measured:
1.0e-4 on Wu, 2x2 mesh vs one device, H100). The steps use the CLI's default AdaGrad beta=1, whose
update lr·g/(1 + sqrt(acc)) has a slope in g of at most lr, so gradient
rounding reaches the params scaled down (with beta=0 the first step from
the 1e-4 accumulator would multiply it by up to lr/0.01). At the default
precision f32 matmuls run in TF32 on Hopper (operands rounded to 10
mantissa bits: up to 2^-10 relative per product), so the largest error
relative to the reference's largest magnitude is reported per array and
held to a first-order bound with a margin: DEFAULT_TOL = 1e-2 for scores
(two chained matmuls, encode then decode: ~2e-3), STEP_TOL = 3e-2 for a
train step (five chained matmuls, and AdaGrad's accumulator squares the
gradient: 5 x 2^-10 x 2 ~ 1e-2). Top-k ids must equal the reference's
except where the reference scores tie exactly (highest), or lie within
DEFAULT_TOL x max|score| of the k-th score (default).

The last line printed is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20141119
U, I, DEG, D, B = 6040, 3706, 160, 50, 1024
TOPK_B, TOPK_I, K = 256, 1_000_000, 10
HI_RTOL, HI_ATOL, HI_ATOL_REL = 1e-4, 1e-5, 3e-4
DEFAULT_TOL = 1e-2
STEP_TOL = 3e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref| (0 when both are all zero)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    diff = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    return diff / scale if scale > 0 else diff


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def check_close(got, ref, what: str) -> None:
    """The "highest"-precision agreement rule (module docstring)."""
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=HI_RTOL,
                               atol=HI_ATOL + HI_ATOL_REL * scale,
                               err_msg=what)


# ------------------------------------------------------------------ device --

def device_phase(expect_count: int):
    """Print the card and the devices; stop unless JAX runs on GPUs."""
    from bench import gpu_name_and_power_limit

    try:
        gpu = gpu_name_and_power_limit()
    except (OSError, subprocess.SubprocessError) as e:  # no nvidia-smi
        gpu = None
        log(f"nvidia-smi: unavailable ({e!r})")
    else:
        log(gpu)
    import jax

    devs = jax.devices()
    log(f"jax.devices(): {devs}")
    if devs[0].platform != "gpu":
        log(f"no GPU: platform is {devs[0].platform!r}")
        raise SystemExit(2)
    check(gpu is not None, "nvidia-smi must report the card")
    check(len(devs) >= expect_count,
          f"{expect_count} GPUs needed, found {len(devs)}")
    return devs


# ------------------------------------------------------------------- train --

def _write_movielens(data, path: str) -> None:
    lines = [f"{u}::{i}::1::0" for u, i in zip(data.users.tolist(),
                                                 data.items.tolist())]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def train_phase(data) -> None:
    import jax

    from cdae_jax import cli

    with tempfile.TemporaryDirectory() as tmp:
        text = os.path.join(tmp, "ml.txt")
        cache = os.path.join(tmp, "ml.bin")
        _write_movielens(data, text)
        cli.run(["--task", "prepare", "--input_file", text,
                 "--cache_file", cache, "--parser", "movielens"])
        for dense in ("auto", "false"):
            argv = [
                "--task", "train", "--method", "CDAE", "--cache_file", cache,
                "--num_dim", str(D), "--cratio", "0.5", "--scaled", "true",
                "--num_neg", "5", "--loss_type", "SQUARE",
                "--adagrad", "true", "--batch_size", str(B),
                "--max_iters", "3", "--eval_iters", "3", "--eval", "TOPN",
                "--checkpoint", os.path.join(tmp, f"cdae_{dense}.ckpt"),
                "--dense_mode", dense,
            ]
            t0 = time.perf_counter()
            solver = cli.run(argv)
            wall = time.perf_counter() - t0
            state = solver.state
            mode = "dense" if "dense_R" in state.aux else "sparse"
            check(mode == ("dense" if dense == "auto" else "sparse"),
                  f"--dense_mode {dense} ran the {mode} path")
            finite = all(bool(jax.numpy.isfinite(v).all())
                         for v in state.params.values())
            first, last = solver.history[0], solver.history[-1]
            n_train = state.num_users
            rate = 3 * n_train / (last["time"] - first["time"])
            log(f"train[{mode}] CDAE D={D}: users/s={rate:.1f} "
                f"(3 iterations incl. compile + final eval), "
                f"R@10={last['R@10']:.5f} (iter 0: {first['R@10']:.5f}), "
                f"wall {wall:.1f}s, params finite={finite}")
            check(finite, f"non-finite params after {mode} training")
            check(last["R@10"] > 0.0, f"R@10 is 0 after {mode} training")


# ----------------------------------------------------------------- compare --

def _copy(params):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.copy, params)


def topk_agreement(ids, ref_ids, ref_masked_scores, tau: float) -> int:
    """Check top-k ids against a reference: as sets they may differ only
    at scores within ``tau`` of the reference's k-th score, and the list's
    reference scores must be non-increasing within ``tau``. Returns the
    number of ids that differ from the reference list."""
    ids = np.asarray(ids)
    ref_ids = np.asarray(ref_ids)
    ref_scores = np.asarray(ref_masked_scores)
    got_scores = np.take_along_axis(ref_scores, ids, axis=1)
    ref_vals = np.take_along_axis(ref_scores, ref_ids, axis=1)
    kth = ref_vals[:, -1]
    check(bool(np.isfinite(got_scores).all()),
          "top-k returned a rated (masked) item")
    check(bool((np.diff(got_scores, axis=1) <= tau).all()),
          "top-k list is out of order beyond tolerance")
    differ = 0
    for b in range(ids.shape[0]):
        got_set, ref_set = set(ids[b].tolist()), set(ref_ids[b].tolist())
        check(len(got_set) == ids.shape[1], "duplicate ids in a top-k row")
        extra = np.array(sorted(got_set - ref_set), np.int64)
        missing = np.array(sorted(ref_set - got_set), np.int64)
        differ += int((ids[b] != ref_ids[b]).sum())
        if extra.size:
            check(bool((ref_scores[b, extra] >= kth[b] - tau).all()),
                  f"row {b}: an id outside the reference top-k beyond tol")
        if missing.size:
            check(bool((ref_scores[b, missing] <= kth[b] + tau).all()),
                  f"row {b}: a reference id dropped beyond tol")
    return differ


def _heavy_tailed_rated(rng, rows: int, num_items: int) -> np.ndarray:
    """(rows, L) sorted rated ids padded with num_items; Pareto lengths
    (at most 4000, and at most half the catalog)."""
    cap = min(4000, num_items // 2)
    lengths = np.minimum((rng.pareto(1.2, rows) * 20).astype(int) + 1, cap)
    L = int(lengths.max())
    rated = np.full((rows, L), num_items, np.int32)
    for b, n in enumerate(lengths):
        ids = np.unique(rng.integers(0, num_items, n))
        rated[b, :len(ids)] = ids
    return rated


def compare_phase(data, *, batch=B, dim=D, topk_batch=TOPK_B,
                  topk_items=TOPK_I, seed=0) -> dict:
    """Timed path vs plain references; returns the measured errors."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from cdae_jax.models.base import iter_user_batches
    from cdae_jax.models.cdae import CDAE, CDAEConfig
    from cdae_jax.ops.topk import mask_rated, streaming_topk_scores

    highest = jax.default_matmul_precision("highest")
    out = {}

    # -- dense step vs the independent sparse step (no randomness) --
    cfg = CDAEConfig(num_dim=dim, loss="SQUARE", corruption_ratio=0.0,
                     num_neg=0, batch_size=batch, bucket_by_length=False,
                     scaled=True, beta=1.0)
    m_dense = CDAE(dataclasses.replace(cfg, dense_mode=True))
    m_sparse = CDAE(dataclasses.replace(cfg, dense_mode=False))
    s_dense = m_dense.reset(data, seed=seed)
    s_sparse = m_sparse.reset(data, seed=seed)
    b = next(iter_user_batches(s_sparse.padded, batch,
                               bucket_by_length=False))
    uids, weight = jnp.asarray(b.uids), jnp.asarray(b.weight)
    key = jax.random.PRNGKey(seed)
    R = s_dense.aux["dense_R"]
    with highest:
        ref = m_sparse._train_step(
            _copy(s_sparse.params), uids, jnp.asarray(b.items),
            jnp.asarray(b.mask), jnp.asarray(b.lengths), weight, key)
        got_hi = m_dense._dense_step(_copy(s_dense.params), R, uids,
                                     weight, key)
    got = m_dense._dense_step(_copy(s_dense.params), R, uids, weight, key)
    ref, got_hi, got = jax.device_get((ref, got_hi, got))
    check(set(ref) == set(got), "dense and sparse param sets differ")
    for k in ref:
        check_close(got_hi[k], ref[k], f"dense step {k}")
    per_param = {k: rel_err(got[k], ref[k]) for k in sorted(ref)}
    out["dense_step_highest"] = max(rel_err(got_hi[k], ref[k]) for k in ref)
    out["dense_step_default"] = max(per_param.values())
    log(f"compare dense step vs sparse step (B={batch}, I={data.num_items}, "
        f"D={dim}): highest rel err {out['dense_step_highest']:.3e} "
        f"(rtol {HI_RTOL}, atol {HI_ATOL} + {HI_ATOL_REL} x max); default "
        f"rel err "
        f"{out['dense_step_default']:.3e} (tol {STEP_TOL}); per array "
        + " ".join(f"{k}={v:.2e}" for k, v in per_param.items()))
    check(out["dense_step_default"] <= STEP_TOL,
          "dense step at default precision beyond tolerance")

    # -- batch scores: default precision vs highest --
    s_dense.params = jax.tree.map(jnp.asarray, ref)
    ri, rm = s_sparse.padded.items[b.uids], s_sparse.padded.mask[b.uids]
    with highest:
        sc_ref = m_dense.batch_scores(s_dense, b.uids, ri, rm)
    sc = m_dense.batch_scores(s_dense, b.uids, ri, rm)
    out["scores_default"] = rel_err(sc, sc_ref)
    log(f"compare CDAE.batch_scores ({batch}x{data.num_items}): default vs "
        f"highest rel err {out['scores_default']:.3e} (tol {DEFAULT_TOL})")
    check(bool(jnp.isfinite(sc).all()), "non-finite scores")
    check(out["scores_default"] <= DEFAULT_TOL, "scores beyond tolerance")

    # -- huge-catalog streaming top-k vs a full masked score matrix --
    rng = np.random.default_rng(seed + 1)
    s = 4.0 * np.sqrt(6.0 / (topk_items + dim))  # CDAE init scale
    z = jnp.asarray(rng.uniform(0, 1, (topk_batch, dim)), jnp.float32)
    W = jnp.asarray(rng.uniform(-s, s, (topk_items, dim)), jnp.float32)
    bp = jnp.asarray(rng.normal(0, 0.01, topk_items), jnp.float32)
    rated = jnp.asarray(_heavy_tailed_rated(rng, topk_batch, topk_items))
    with highest:
        masked = mask_rated(z @ W.T + bp[None, :], rated)
        ref_vals, ref_ids = jax.lax.top_k(masked, K)
        ids_hi, _ = streaming_topk_scores(z, W, bp, rated, k=K)
    ids, _ = streaming_topk_scores(z, W, bp, rated, k=K)
    masked_np = np.asarray(masked)
    ref_ids = np.asarray(ref_ids)
    diff_hi = topk_agreement(ids_hi, ref_ids, masked_np, tau=0.0)
    tau = DEFAULT_TOL * float(np.max(np.abs(np.asarray(ref_vals))))
    diff = topk_agreement(ids, ref_ids, masked_np, tau=tau)
    out["topk_ids_differ_highest"] = diff_hi
    out["topk_ids_differ_default"] = diff
    log(f"compare streaming top-{K} ({topk_batch}x{topk_items}, D={dim}, "
        f"rated rows up to {rated.shape[1]}): highest {diff_hi} ids differ "
        f"(exact ties only); default {diff} ids differ (all within "
        f"{tau:.3e} of the k-th score)")
    return out


# ------------------------------------------------------------------- multi --

def multi_phase(data, *, batch=B, dim=D, iters=2, seed=0) -> dict:
    """Dense ShardedCDAE on a 2x2 mesh vs single-device CDAE."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cdae_jax.models.cdae import CDAE, CDAEConfig
    from cdae_jax.ops.topk import mask_rated, topk_unrated
    from cdae_jax.parallel.mesh import make_mesh
    from cdae_jax.parallel.sharded import shard_cdae_state
    from cdae_jax.parallel.topk import distributed_topk_unrated
    from cdae_jax.parallel.trainer import ShardedCDAE

    highest = jax.default_matmul_precision("highest")
    out = {}
    mesh = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    cfg = CDAEConfig(num_dim=dim, loss="SQUARE", corruption_ratio=0.5,
                     scaled=True, num_neg=5, batch_size=batch,
                     dense_mode=True, beta=1.0)
    sharded = ShardedCDAE(cfg, mesh=mesh)
    st_sh = sharded.reset(data, seed=seed)
    single = CDAE(cfg)
    st_1 = single.reset(data, seed=seed)
    host0 = jax.device_get(st_1.params)
    uid_mat, w_mat = single._dense_batches(st_1)
    uids, w = uid_mat[0], w_mat[0]
    data_sh = NamedSharding(mesh, P("data"))
    uids_sh, w_sh = jax.device_put(uids, data_sh), jax.device_put(w, data_sh)
    key = jax.random.PRNGKey(seed + 7)

    def one_step(sharded_side):
        if sharded_side:
            return sharded._dense_step(shard_cdae_state(mesh, host0),
                                       st_sh.aux["dense_R"], uids_sh, w_sh,
                                       key)
        return single._dense_step(jax.tree.map(jnp.asarray, host0),
                                  st_1.aux["dense_R"], uids, w, key)

    with highest:
        p1_hi, psh_hi = jax.device_get((one_step(False), one_step(True)))
    p1, psh = jax.device_get((one_step(False), one_step(True)))
    for k in p1_hi:
        check_close(psh_hi[k], p1_hi[k], f"sharded step {k}")
    out["step_highest"] = max(rel_err(psh_hi[k], p1_hi[k]) for k in p1_hi)
    out["step_default"] = max(rel_err(psh[k], p1[k]) for k in p1)
    log(f"multi: sharded dense step (2x2 mesh) vs single device: highest "
        f"rel err {out['step_highest']:.3e} (rtol {HI_RTOL}, atol "
        f"{HI_ATOL} + {HI_ATOL_REL} x max); default rel err "
        f"{out['step_default']:.3e} (tol {STEP_TOL})")
    check(out["step_default"] <= STEP_TOL,
          "sharded step at default precision beyond tolerance")

    t0 = time.perf_counter()
    for it in range(iters):
        st_sh = sharded.train_one_iteration(
            st_sh, jax.random.fold_in(key, it))
    jax.block_until_ready(st_sh.params)
    trained = jax.device_get(st_sh.params)
    check(all(np.isfinite(v).all() for v in trained.values()),
          "non-finite sharded params")
    log(f"multi: {iters} sharded iterations ({iters * uid_mat.shape[0]} "
        f"steps) in {time.perf_counter() - t0:.2f}s incl. compile")

    st_1.params = jax.tree.map(jnp.asarray, trained)
    eval_uids = np.arange(batch)
    ri = st_1.padded.items[eval_uids]
    rm = st_1.padded.mask[eval_uids]
    with highest:
        sc_sh = sharded.batch_scores(st_sh, eval_uids, ri, rm)
        sc_1 = single.batch_scores(st_1, eval_uids, ri, rm)
        ids_sh, _ = distributed_topk_unrated(
            mesh, sc_sh, jax.device_put(ri, NamedSharding(mesh, P("data"))),
            K)
        ref_ids, _ = topk_unrated(sc_1, jnp.asarray(ri), K)
        masked = mask_rated(sc_1, jnp.asarray(ri))
    sc_sh_np, sc_1_np = np.asarray(sc_sh), np.asarray(sc_1)
    check_close(sc_sh_np, sc_1_np, "sharded scores")
    out["scores_highest"] = rel_err(sc_sh_np, sc_1_np)
    tau = float(np.max(np.abs(sc_sh_np - sc_1_np)))
    out["topk_ids_differ"] = topk_agreement(ids_sh, ref_ids,
                                            np.asarray(masked), tau=tau)
    log(f"multi: sharded scores vs single ({batch}x{data.num_items}) rel err "
        f"{out['scores_highest']:.3e}; distributed top-{K}: "
        f"{out['topk_ids_differ']} ids differ (within the scores' own "
        f"max difference {tau:.3e})")
    return out


# -------------------------------------------------------------------- main --

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    devs = device_phase(4 if args.multi else 1)

    from bench import synthetic_interactions

    data = synthetic_interactions(U, I, DEG, seed=SEED)
    log(f"data: {data.num_users} users x {data.num_items} items, "
        f"{len(data.users)} interactions")
    phases = ((("multi", multi_phase),) if args.multi else
              (("train", train_phase), ("compare", compare_phase)))
    for name, fn in phases:
        t0 = time.perf_counter()
        fn(data)
        log(f"phase {name}: {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
