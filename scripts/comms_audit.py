#!/usr/bin/env python
"""Collective-communication audit of every sharded step (VERDICT r1 item 4).

Compiles each GSPMD-sharded program on a fake 8-device CPU mesh
(4 data x 2 model), extracts the optimized HLO, and inventories the
inserted collectives (all-gather / all-reduce / reduce-scatter /
collective-permute / all-to-all) with their operand shapes and byte sizes.

The specific risk being audited: the sparse CDAE train step shards W by
item rows; if GSPMD decided to all-gather the FULL (I, D) table per step,
item-axis TP would be a bandwidth fiction. The audit asserts the largest
all-gather is far below full-table size.

Run: python scripts/comms_audit.py [--out COMMS.md]
"""
import argparse
import os
import re
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import numpy as np


_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8, "u64": 8,
                "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "pred": 1, "s8": 1,
                "u8": 1}


def shape_bytes(shape_str):
    """'f32[128,50]' -> 25600; tuple shapes sum their leaves."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def audit_hlo(hlo: str):
    """Inventory collective ops in optimized HLO text."""
    kinds = ("all-gather", "all-reduce", "reduce-scatter",
             "collective-permute", "all-to-all")
    out = []
    for line in hlo.splitlines():
        s = line.strip()
        m = re.match(r"(?:ROOT )?%?[\w.\-]+ = (\S+) (all-gather|all-reduce|"
                     r"reduce-scatter|collective-permute|all-to-all)", s)
        if m and not s.startswith("//"):
            shape, kind = m.group(1), m.group(2)
            out.append({"kind": kind, "shape": shape,
                        "bytes": shape_bytes(shape)})
    agg = {}
    for o in out:
        k = o["kind"]
        agg.setdefault(k, {"count": 0, "bytes": 0, "max_bytes": 0})
        agg[k]["count"] += 1
        agg[k]["bytes"] += o["bytes"]
        agg[k]["max_bytes"] = max(agg[k]["max_bytes"], o["bytes"])
    return out, agg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--users", type=int, default=512)
    ap.add_argument("--items", type=int, default=1024)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cdae_jax.data.dataset import Interactions
    from cdae_jax.models.cdae import CDAE, CDAEConfig
    from cdae_jax.models.mf import IMF, MFConfig
    from cdae_jax.parallel.mesh import make_mesh
    from cdae_jax.parallel.sharded import (
        make_batch,
        make_sharded_dense_step,
        make_sharded_mf_dense_step,
        make_sharded_scores,
        make_sharded_train_step,
        shard_cdae_state,
    )

    rng = np.random.default_rng(0)
    U, I, B = args.users, args.items, args.batch
    pairs = np.unique(rng.integers(0, U * I, U * 40))
    data = Interactions.from_arrays(
        (pairs // I).astype(np.int32), (pairs % I).astype(np.int32),
        num_users=U, num_items=I,
    )
    mesh = make_mesh(n_data=4, n_model=2)
    model = CDAE(CDAEConfig(num_dim=args.dim, batch_size=B, loss="SQUARE"))
    state = model.reset(data, seed=0)
    params = shard_cdae_state(mesh, state.params)
    pb = state.padded
    key = jax.random.PRNGKey(0)

    reports = {}

    # --- sparse CDAE train step ---
    step = make_sharded_train_step(model, mesh, params)
    uids, items, mask, lengths, weight = make_batch(
        pb, np.arange(U, dtype=np.int32), B)
    lowered = step.lower(params, jnp.asarray(uids), jnp.asarray(items),
                         jnp.asarray(mask), jnp.asarray(lengths),
                         jnp.asarray(weight), key)
    hlo = lowered.compile().as_text()
    reports["cdae_sparse_train_step"] = audit_hlo(hlo)

    # --- dense CDAE train step ---
    model2 = CDAE(CDAEConfig(num_dim=args.dim, batch_size=B, loss="SQUARE", dense_mode=True))
    state2 = model2.reset(data, seed=0)
    params2 = shard_cdae_state(mesh, state2.params)
    dstep = make_sharded_dense_step(model2, mesh, params2)
    R = state2.aux["dense_R"].astype(jnp.int8)
    duids = jnp.arange(B, dtype=jnp.int32)
    dw = jnp.ones((B,), jnp.float32)
    hlo = dstep.lower(params2, R, duids, dw, key).compile().as_text()
    reports["cdae_dense_train_step"] = audit_hlo(hlo)

    # --- dense IMF step ---
    mf = IMF(MFConfig(num_dim=args.dim, batch_size=B, dense_mode=True))
    mstate = mf.reset(data, seed=0)
    from cdae_jax.parallel.mesh import mf_param_specs, shard_params

    mparams = shard_params(mesh, mstate.params, mf_param_specs(mstate.params))
    mstep = make_sharded_mf_dense_step(mf, mesh, mparams)
    mR = mstate.aux["dense_R"]
    hlo = mstep.lower(mparams, mR, mR, duids, dw, key).compile().as_text()
    reports["imf_dense_step"] = audit_hlo(hlo)

    # --- sharded pairwise epoch (BPR under DP, factored one-hot grads) ---
    from cdae_jax.models.mf import BPR
    from cdae_jax.parallel.trainer import ShardedPairwise

    pw = ShardedPairwise(
        BPR(MFConfig(num_dim=args.dim, num_neg=2, batch_size=B,
                     dense_mode=False)),
        mesh=mesh,
    )
    pstate = pw.reset(data, seed=0)
    n = len(pstate.aux["coo"][0])
    nb = max(-(-n // B), 1)
    # mirror the trainer's real path: external physically-sharded selection
    # + the shard_map aggregation hook (see ShardedPairwise notes below)
    from jax.sharding import NamedSharding, PartitionSpec as PS

    from cdae_jax.ops.scatter import batch_axis_mesh

    fn = pw.inner._epoch_fn(nb, constrain=pw._constrain, external_perm=True)
    du, di, dr, dpi, dpl = pw._sharded_device_data(pstate)
    sel = jax.device_put(jnp.zeros((nb, B), jnp.int32),
                         NamedSharding(mesh, PS(None, "data")))
    wm = jax.device_put(jnp.ones((nb, B), jnp.float32),
                        NamedSharding(mesh, PS(None, "data")))
    with batch_axis_mesh(mesh, "data"):
        hlo = jax.jit(fn).lower(pstate.params, du, di, dr, dpi, dpl,
                                sel, wm, key).compile().as_text()
    reports["bpr_pairwise_epoch"] = audit_hlo(hlo)

    # --- item-sharded TP pairwise epoch (explicit shard_map collectives) ---
    from cdae_jax.parallel.tp_pairwise import ShardedMFTP

    tp = ShardedMFTP(
        BPR(MFConfig(num_dim=args.dim, num_neg=2, batch_size=B,
                     dense_mode=False)),
        mesh=mesh,
    )
    tstate = tp.reset(data, seed=0)
    tn = len(tstate.aux["coo"][0])
    tep = tp._build_epoch(max(-(-tn // B), 1), U)
    tdu, tdi, tdr, tdpi, tdpl = tp._device_data(tstate)
    hlo = tep.lower(tstate.params, tdu, tdi, tdr, tdpi, tdpl,
                    key).compile().as_text()
    reports["bpr_tp_epoch"] = audit_hlo(hlo)

    # --- sharded dense FISM step ---
    from cdae_jax.models.fism import FISMConfig
    from cdae_jax.parallel.trainer import ShardedFISM

    sf = ShardedFISM(FISMConfig(num_dim=args.dim, num_neg=2, batch_size=B,
                                dense_mode=True), mesh=mesh)
    fstate = sf.reset(data, seed=0)
    fuids, fw = sf._sharded_dense_batches(fstate)
    hlo = sf._dense_step.lower(
        fstate.params, fstate.aux["dense_R"], fuids[0], fw[0],
        jnp.float32(0.01), key,
    ).compile().as_text()
    reports["fism_dense_step"] = audit_hlo(hlo)

    # --- sharded full-catalog scoring ---
    scores = make_sharded_scores(model, mesh, params)
    hlo = scores.lower(
        params, jnp.asarray(uids[:B]),
        jnp.asarray(pb.items[:B]), jnp.asarray(pb.mask[:B]),
    ).compile().as_text()
    reports["cdae_batch_scores"] = audit_hlo(hlo)

    # --- report ---
    W_bytes = U and state.params["W"].size * 4
    lines = [
        "# COMMS — collective inventory of the sharded paths",
        "",
        f"Mesh 4x2 ('data','model'), fake CPU devices; workload "
        f"{U}u x {I}i, dim {args.dim}, batch {B}. Optimized-HLO audit "
        "(scripts/comms_audit.py). Byte sizes are per-program-instance "
        "(per-shard) operand sizes.",
        "",
    ]
    ok = True
    for name, (ops, agg) in reports.items():
        lines.append(f"## {name}")
        lines.append("")
        if not ops:
            lines.append("(no collectives — fully local)")
        else:
            lines.append("| collective | count | total bytes | max op bytes |")
            lines.append("|---|---|---|---|")
            for k, v in sorted(agg.items()):
                lines.append(
                    f"| {k} | {v['count']} | {v['bytes']:,} | "
                    f"{v['max_bytes']:,} |")
        lines.append("")
        if name == "bpr_tp_epoch":
            iv_full = args.items * args.dim * 4
            big = max((o["bytes"] for o in ops), default=0)
            verdict = (
                f"OK: largest collective op ({big:,} B) << full iv table "
                f"({iv_full:,} B) — the item-sharded TP epoch moves only "
                "O(B·nn·D) row reconstructions (psum over 'model') and "
                "contribution rows (all-gather over 'data'); per-chip "
                "item-table memory is I/n_model rows."
                if big < iv_full // 2 else
                f"WARNING: largest collective {big:,} B vs full iv "
                f"{iv_full:,} B — the TP epoch may be moving whole tables."
            )
            ok = ok and big < iv_full // 2
            lines.append(verdict)
            lines.append("")
        if name == "cdae_sparse_train_step":
            full_W = state.params["W"].size * 4
            shard_W = full_W // 2  # item axis split over n_model=2
            big_ag = max((o["bytes"] for o in ops
                          if o["kind"] == "all-gather"), default=0)
            big_ar = max((o["bytes"] for o in ops
                          if o["kind"] == "all-reduce"), default=0)
            verdict = (
                f"OK: largest all-gather ({big_ag:,} B) << full W table "
                f"({full_W:,} B) — GSPMD does NOT materialize the whole "
                "item table in the sparse step; item-axis TP is real."
                if big_ag < shard_W // 2 else
                f"WARNING: largest all-gather {big_ag:,} B vs full W "
                f"{full_W:,} B — inspect HLO, the item table may be "
                "gathered whole."
            )
            ok = ok and big_ag < shard_W // 2
            lines.append(verdict)
            lines.append("")
            if big_ar == shard_W:
                lines.append(
                    f"The {big_ar:,} B all-reduces are exactly W-shard-sized "
                    "((I/n_model) x D x f32): the data-parallel gradient psum "
                    "over the 'data' axis for the locally-owned item rows — "
                    "the expected DP cost, riding ICI, proportional to the "
                    "SHARD, not the full table.")
                lines.append("")
    lines.append(
        "## ShardedPairwise partitioning notes\n\n"
        "The pairwise epoch's batch data is fed PHYSICALLY sharded over "
        "'data' (an internal with_sharding_constraint derived from "
        "replicated inputs is elidable — measured zero collectives), and "
        "the factored one-hot aggregation runs inside an explicit "
        "shard_map (local partial dots + psum, ops/scatter."
        "batch_axis_mesh). The per-pair math (sampling, preds, loss "
        "grads) is distributed; for the aggregation dot XLA may still "
        "legalize partial-dot+psum back into gather-compact-operands + "
        "replicated dot at small per-row widths (observed both plans on "
        "the CPU mesh — the gathers above are those compact (P, D+1) "
        "value rows, sub-MB per batch either way). Real-chip scaling "
        "numbers require multi-host hardware (1 chip here).\n")
    text = "\n".join(lines)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
