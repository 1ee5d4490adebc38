#!/usr/bin/env python
"""Headline benchmark: CDAE training throughput on the accelerator vs the
reference CPU implementation.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...,
   "device": {...}, "gpu": "<name>, <power limit>"}

Workload: the canonical Yelp/ML-1M-scale CDAE config (dim=50, corruption 0.5
scaled, num_neg=5, SQUARE loss, AdaGrad — ref apps/yelp/cdae.sh:3-25) on a
synthetic 6040-user x 3706-item dataset with a geometric degree distribution
(mean 160 interactions/user, ~ML-1M density). Metric: training users/sec
(one corruption pass per user per epoch, like ref cdae.hpp:136-146).

Baseline: the reference repo publishes NO numbers (BASELINE.md), and its
binary cannot be built here (Eigen/Boost absent), so the baseline is a
faithful from-scratch C++ reproduction of its sequential per-user hot loop
(csrc/baseline_cdae.cpp), measured on one CPU core.
Set BENCH_MEASURE_BASELINE=1 to re-measure live (compiles with g++ -O3).

Env knobs: BENCH_USERS, BENCH_ITEMS, BENCH_DEG, BENCH_DIM, BENCH_BATCH,
BENCH_EPOCHS, BENCH_SECONDS, BENCH_BF16.

Run on the accelerator: ``python bench.py``. A device missing from
``PEAKS`` is an error: the script does not fall back to the CPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))

# measured via csrc/baseline_cdae.cpp on one core of an
# "Intel(R) Xeon(R) Processor @ 2.10GHz":
# {"users_per_sec": 4021.23, U=6040, I=3706, deg=160, dim=50}
BASELINE_USERS_PER_SEC = 4021.0
# the CPU the constant was measured on — if the host differs, the frozen
# baseline skews vs_baseline, so warn
BASELINE_CPU_MODEL = "Intel(R) Xeon(R) Processor @ 2.10GHz"

# Published dense peaks per device, keyed by jax's device_kind. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM column, dense rates without
# sparsity, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """Peaks for ``device_kind``; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card, from nvidia-smi (a child
    process that never opens the card through JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def synthetic_interactions(num_users, num_items, avg_degree, seed=20141119):
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
        num_users=num_users,
        num_items=num_items,
    )


def measure_baseline(U, I, deg, dim, seconds=20.0):
    src = os.path.join(_ROOT, "csrc", "baseline_cdae.cpp")
    exe = os.path.join(_ROOT, "csrc", "baseline_cdae")  # gitignored
    subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", "-o", exe, src],
        check=True,
    )
    out = subprocess.run(
        [exe, str(U), str(I), str(deg), str(dim), str(seconds)],
        check=True, capture_output=True, text=True,
    ).stdout
    return float(json.loads(out)["users_per_sec"])


def main():
    U = int(os.environ.get("BENCH_USERS", 6040))
    I = int(os.environ.get("BENCH_ITEMS", 3706))
    deg = int(os.environ.get("BENCH_DEG", 160))
    dim = int(os.environ.get("BENCH_DIM", 50))
    batch = int(os.environ.get("BENCH_BATCH", 1536))
    min_epochs = int(os.environ.get("BENCH_EPOCHS", 3))
    budget_s = float(os.environ.get("BENCH_SECONDS", 30))
    bf16 = bool(os.environ.get("BENCH_BF16"))

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    peaks = device_peaks(dev.device_kind)  # before any timed work
    gpu = gpu_name_and_power_limit()

    baseline = BASELINE_USERS_PER_SEC
    if os.environ.get("BENCH_MEASURE_BASELINE"):
        baseline = measure_baseline(U, I, deg, dim)
        print(f"# measured baseline: {baseline:.1f} users/s", file=sys.stderr)
    elif _cpu_model() != BASELINE_CPU_MODEL:
        print(f"# WARNING: host CPU is {_cpu_model()!r}, baseline constant "
              f"was measured on {BASELINE_CPU_MODEL!r} — vs_baseline may be "
              "skewed; set BENCH_MEASURE_BASELINE=1 to re-measure",
              file=sys.stderr)

    from cdae_jax.utils.compile_cache import enable as _enable_cache

    _enable_cache()

    from cdae_jax.models.cdae import CDAE, CDAEConfig

    data = synthetic_interactions(U, I, deg)
    model = CDAE(CDAEConfig(
        num_dim=dim, learn_rate=0.1, lambda_=0.01, loss="SQUARE",
        corruption_ratio=0.5, scaled=True, num_neg=5, user_factor=True,
        batch_size=batch, compute_dtype=jnp.bfloat16 if bf16 else None,
    ))
    state = model.reset(data, seed=0)
    key = jax.random.PRNGKey(0)

    # warmup: compiles the fused multi-epoch program
    chunk = max(min_epochs, 10)  # epochs per device program
    key, sub = jax.random.split(key)
    state = model.train_epochs(state, chunk, sub)
    jax.block_until_ready(state.params)

    t0 = time.perf_counter()
    epochs = 0
    while epochs < min_epochs or time.perf_counter() - t0 < budget_s:
        key, sub = jax.random.split(key)
        state = model.train_epochs(state, chunk, sub)
        jax.block_until_ready(state.params)
        epochs += chunk
        if epochs >= 600:
            break
    users_per_sec = U * epochs / (time.perf_counter() - t0)

    # --- MFU accounting ------------------------------------------------------
    # Dense-mode CDAE model FLOPs: 5 (B,I)x(I,D)-class matmuls per epoch
    # pass (encode, decode, decode-grad, hidden-grad, encode-grad), i.e.
    # ~10·U·I·D useful FLOPs per epoch, against the published bf16 peak
    # (the honest denominator for "distance to silicon" even while the
    # compute dtype is f32).
    model_flop_per_epoch = 10.0 * U * I * dim
    achieved_flops = model_flop_per_epoch * users_per_sec / U

    # --- memory roofline accounting -----------------------------------------
    # Two traffic models BRACKET the dense step's device-memory bytes/epoch:
    # COMPULSORY (lower bound): the int8 interaction rows once per epoch,
    # plus the (I, D) parameter tables + AdaGrad accumulators (~2 reads + 1
    # write each) and b'/accumulator vectors per batch; RNG masks are
    # generated on chip (zero bytes).
    # SLAB (upper bound — every (B, I) fusion-boundary slab spills): counted
    # from _dense_train_step: 17 slab-dtype + 2 f32 + 1 int8 passes per
    # (B, I) cell. slab_hbm_frac > 1 means the slabs provably stay on chip
    # (cache-resident) and the step is not bound by device memory.
    slab_bytes = 2 if bf16 else 4
    n_batches = -(-U // batch)
    params_bytes = n_batches * (3 * 2 * I * dim * 4 + 3 * 2 * I * 4)
    compulsory_bytes = U * I * 1 + params_bytes
    slab_model_bytes = U * I * (17 * slab_bytes + 2 * 4 + 1) + params_bytes
    hbm = peaks["hbm_bytes_per_s"]
    epochs_per_sec = users_per_sec / U
    hbm_bound_users_per_sec = hbm / compulsory_bytes * U
    slab_hbm_frac = slab_model_bytes * epochs_per_sec / hbm
    print(json.dumps({
        "metric": "cdae_train_users_per_sec",
        "value": users_per_sec,
        "unit": "users/s",
        "vs_baseline": users_per_sec / baseline,
        "achieved_tflops": achieved_flops / 1e12,
        "mfu_vs_bf16_peak": achieved_flops / peaks["bf16_flops"],
        "frac_of_hbm_roofline": users_per_sec / hbm_bound_users_per_sec,
        "slab_hbm_frac": slab_hbm_frac,
        "memory_bound": slab_hbm_frac <= 1.0,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "gpu": gpu,
    }))


if __name__ == "__main__":
    sys.exit(main() or 0)
