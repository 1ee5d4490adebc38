#!/usr/bin/env python
"""Multi-process scaling harness (VERDICT r1 item 4, second half).

WEAK-scaling measurement of the sharded dense CDAE train step across REAL
process boundaries: N in {1, 2, 4} JAX processes on CPU, each pinned to
its own core (taskset) with single-threaded XLA compute, pure-DP mesh over
the 'data' axis, FIXED PER-PROCESS batch (global batch = N x local). The
per-step gradient all-reduce (see COMMS.md) crosses the jax.distributed
transport exactly as it would cross the interconnect between hosts.

Weak-scaling efficiency = t_1proc / t_Nproc: the fraction of a step NOT
lost to collectives/rendezvous as processes are added. Aggregate users/s
should grow ~linearly; the step-time delta vs 1 proc IS the measured
collective overhead. (On this 4-core host the absolute numbers are
CPU-bound; the harness and efficiency metric are what transfer to real
multi-host runs.)

Run: python scripts/scaling_procs.py [--steps 30] [--batch 128]
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

_WORKER = r"""
import json, os, sys, time
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=1 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax
jax.config.update("jax_platforms", "cpu")
from cdae_jax.parallel.distributed import initialize
initialize()
import numpy as np
import jax.numpy as jnp
from cdae_jax.data.dataset import Interactions
from cdae_jax.models.cdae import CDAE, CDAEConfig
from cdae_jax.parallel.mesh import make_mesh
from cdae_jax.parallel.sharded import (
    make_sharded_dense_step, shard_cdae_state)

B_LOCAL = int(os.environ["SCALE_BATCH"])    # per-process batch (fixed)
STEPS = int(os.environ["SCALE_STEPS"])
U, I, D = 1024, 2048, 64

rng = np.random.default_rng(0)
pairs = np.unique(rng.integers(0, U * I, U * 60))
data = Interactions.from_arrays((pairs // I).astype(np.int32),
                                (pairs % I).astype(np.int32),
                                num_users=U, num_items=I)
B = B_LOCAL * jax.process_count()           # global batch grows with N
model = CDAE(CDAEConfig(num_dim=D, batch_size=B, loss="SQUARE", dense_mode=True))
state = model.reset(data, seed=0)
mesh = make_mesh()  # all devices on 'data' (pure DP), n_model=1
params = shard_cdae_state(mesh, state.params)
step = make_sharded_dense_step(model, mesh, params)
from jax.sharding import NamedSharding, PartitionSpec as P
R = jax.device_put(state.aux["dense_R"],
                   NamedSharding(mesh, P("data", "model")))
uids = jax.device_put(jnp.arange(B, dtype=jnp.int32) % U,
                      NamedSharding(mesh, P("data")))
w = jax.device_put(jnp.ones((B,), jnp.float32),
                   NamedSharding(mesh, P("data")))
key = jax.random.PRNGKey(0)

params = step(params, R, uids, w, key)     # compile + warmup
_ = float(jnp.sum(params["W"]))            # forced readback barrier
t0 = time.perf_counter()
for s in range(STEPS):
    params = step(params, R, uids, w, jax.random.fold_in(key, s))
_ = float(jnp.sum(params["W"]))
dt = time.perf_counter() - t0
if jax.process_index() == 0:
    print(json.dumps({"procs": jax.process_count(),
                      "users_per_sec": round(B * STEPS / dt, 1),
                      "step_ms": round(dt / STEPS * 1e3, 2)}))
"""


_WORKER_BPR = r"""
import json, os, sys, time
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=1 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax
jax.config.update("jax_platforms", "cpu")
from cdae_jax.parallel.distributed import initialize
initialize()
import numpy as np
import jax.numpy as jnp
from cdae_jax.data.dataset import Interactions
from cdae_jax.models.mf import BPR, MFConfig
from cdae_jax.parallel.mesh import make_mesh
from cdae_jax.parallel.trainer import ShardedPairwise

B_LOCAL = int(os.environ["SCALE_BATCH"])
STEPS = int(os.environ["SCALE_STEPS"])
U, I = 2048, 1024

rng = np.random.default_rng(0)
pairs = np.unique(rng.integers(0, U * I, U * 40))
data = Interactions.from_arrays((pairs // I).astype(np.int32),
                                (pairs % I).astype(np.int32),
                                num_users=U, num_items=I)
B = B_LOCAL * jax.process_count()
model = ShardedPairwise(
    BPR(MFConfig(num_dim=10, num_neg=5, batch_size=B, dense_mode=False)),
    mesh=make_mesh(),
)
state = model.reset(data, seed=0)
key = jax.random.PRNGKey(0)
key, sub = jax.random.split(key)
state = model.train_one_iteration(state, sub)      # compile + warmup epoch
_ = float(jnp.sum(state.params["iv"]))
n_pairs = len(data.users)
t0 = time.perf_counter()
for s in range(STEPS):
    key, sub = jax.random.split(key)
    state = model.train_one_iteration(state, sub)
_ = float(jnp.sum(state.params["iv"]))
dt = time.perf_counter() - t0
if jax.process_index() == 0:
    print(json.dumps({"procs": jax.process_count(),
                      "users_per_sec": round(U * STEPS / dt, 1),
                      "step_ms": round(dt / STEPS * 1e3, 2)}))
"""


_WORKER_TP = r"""
import json, os, sys, time
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=1 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax
jax.config.update("jax_platforms", "cpu")
from cdae_jax.parallel.distributed import initialize
initialize()
import numpy as np
import jax.numpy as jnp
from cdae_jax.data.dataset import Interactions
from cdae_jax.models.mf import BPR, MFConfig
from cdae_jax.parallel.mesh import make_mesh
from cdae_jax.parallel.tp_pairwise import ShardedMFTP

B = int(os.environ["SCALE_BATCH"])
STEPS = int(os.environ["SCALE_STEPS"])
# TP weak scaling: the CATALOG grows with the process count (each process
# owns a fixed I/n_model item block); batch stays fixed. Ideal = flat
# epoch time per interaction.
U, I = 2048, 1024 * jax.process_count()

rng = np.random.default_rng(0)
pairs = np.unique(rng.integers(0, U * I, U * 40))
data = Interactions.from_arrays((pairs // I).astype(np.int32),
                                (pairs % I).astype(np.int32),
                                num_users=U, num_items=I)
model = ShardedMFTP(
    BPR(MFConfig(num_dim=10, num_neg=5, batch_size=B, dense_mode=False)),
    mesh=make_mesh(n_data=1),  # all processes on 'model'
)
state = model.reset(data, seed=0)
gsum = jax.jit(lambda a: jnp.sum(a))  # global-array readback
key = jax.random.PRNGKey(0)
key, sub = jax.random.split(key)
state = model.train_one_iteration(state, sub)      # compile + warmup epoch
_ = float(gsum(state.params["iv"]))
t0 = time.perf_counter()
for s in range(STEPS):
    key, sub = jax.random.split(key)
    state = model.train_one_iteration(state, sub)
_ = float(gsum(state.params["iv"]))
dt = time.perf_counter() - t0
if jax.process_index() == 0:
    print(json.dumps({"procs": jax.process_count(),
                      "items": I,
                      "users_per_sec": round(U * STEPS / dt, 1),
                      "step_ms": round(dt / STEPS * 1e3, 2)}))
"""


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_group(n, batch, steps, repo, model="cdae"):
    port = free_port()
    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write({"bpr": _WORKER_BPR, "tp": _WORKER_TP}.get(model,
                                                               _WORKER))
        procs = []
        for pid in range(n):
            env = dict(
                os.environ,
                CDAE_COORDINATOR=f"localhost:{port}",
                CDAE_NUM_PROCESSES=str(n),
                CDAE_PROCESS_ID=str(pid),
                PYTHONPATH=repo,
                JAX_PLATFORMS="cpu",
                SCALE_BATCH=str(batch),
                SCALE_STEPS=str(steps),
            )
            procs.append(subprocess.Popen(
                ["taskset", "-c", str(pid), sys.executable, script],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ))
        outs = [p.communicate(timeout=900)[0] for p in procs]
        for p, out in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{out}")
        for out in outs:
            for line in out.splitlines():
                if line.startswith("{"):
                    return json.loads(line)
    raise RuntimeError("no result line")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sizes", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--model", default="cdae", choices=["cdae", "bpr", "tp"],
                    help="cdae = sharded dense step; bpr = ShardedPairwise "
                         "fused epoch (step_ms is then ms/EPOCH); tp = "
                         "ShardedMFTP item-sharded epoch, catalog grows "
                         "with the process count (TP weak scaling)")
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    rows = []
    for n in args.sizes:
        r = run_group(n, args.batch, args.steps, repo, model=args.model)
        rows.append(r)
        print(f"# {n} proc(s): {r['users_per_sec']:,} users/s "
              f"({r['step_ms']} ms/step)", file=sys.stderr)
    base_ms = rows[0]["step_ms"]
    for r in rows:
        # weak scaling: ideal keeps step time flat as procs (and global
        # batch) grow; efficiency = t_1 / t_N
        r["weak_efficiency"] = round(base_ms / r["step_ms"], 3)
        r["collective_overhead_ms"] = round(r["step_ms"] - base_ms, 2)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
