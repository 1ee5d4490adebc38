"""Real multi-process collective test: 2 JAX processes on CPU, one psum and
one sharded CDAE step across process boundaries (the multi-host capability
the reference never had, SURVEY §4)."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
from cdae_jax.parallel.distributed import initialize
assert initialize() is True
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from cdae_jax.parallel.mesh import make_mesh

assert jax.process_count() == 2
assert len(jax.devices()) == 4  # 2 procs x 2 local cpu devices

mesh = make_mesh(n_data=2, n_model=2)
# a global array sharded over both axes; sum reduces across processes
x = jnp.ones((8, 8))
xs = jax.device_put(x, NamedSharding(mesh, P("data", "model")))
total = jax.jit(lambda a: jnp.sum(a))(xs)
np.testing.assert_allclose(float(total), 64.0)

# sharded CDAE train step across the 2-process mesh
from cdae_jax.models.cdae import CDAE, CDAEConfig
from cdae_jax.parallel.sharded import (
    make_batch, make_sharded_train_step, shard_cdae_state)
from cdae_jax.data.dataset import Interactions
rng = np.random.default_rng(0)
pairs = np.unique(rng.integers(0, 32 * 64, 400))
data = Interactions.from_arrays((pairs // 64).astype(np.int32),
                                (pairs % 64).astype(np.int32),
                                num_users=32, num_items=64)
model = CDAE(CDAEConfig(num_dim=16, loss="SQUARE", batch_size=16))
state = model.reset(data, seed=0)
params = shard_cdae_state(mesh, state.params)
step = make_sharded_train_step(model, mesh, params)
uids, items, mask, lengths, weight = make_batch(
    state.padded, np.arange(16), 16)
out = step(params, jnp.asarray(uids), jnp.asarray(items), jnp.asarray(mask),
           jnp.asarray(lengths), jnp.asarray(weight), jax.random.PRNGKey(0))
jax.block_until_ready(out)

# item-sharded TP pairwise epoch: iv/ib blocks live on DIFFERENT processes,
# so the psum row-gathers and contribution all-gathers cross the process
# boundary (parallel/tp_pairwise.ShardedMFTP)
from cdae_jax.models.mf import BPR, MFConfig
from cdae_jax.parallel.tp_pairwise import ShardedMFTP
tp = ShardedMFTP(BPR(MFConfig(num_dim=8, num_neg=2, batch_size=16,
                              dense_mode=False)), mesh=mesh)
tstate = tp.reset(data, seed=0)
tstate = tp.train_one_iteration(tstate, jax.random.PRNGKey(1))
jax.block_until_ready(tstate.params)
for s in tstate.params["iv"].addressable_shards:
    assert np.all(np.isfinite(np.asarray(s.data)))

print(f"proc {jax.process_index()} OK")
"""


_WORKER_E2E = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
from cdae_jax.parallel.distributed import initialize
assert initialize() is True
import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils

from cdae_jax.data.dataset import Interactions
from cdae_jax.models.cdae import CDAE, CDAEConfig, _batch_scores
from cdae_jax.ops.metrics import topn_user_metrics
from cdae_jax.ops.topk import topk_unrated
from cdae_jax.parallel.mesh import make_mesh
from cdae_jax.parallel.trainer import ShardedCDAE
from cdae_jax.utils import checkpoint as ckpt

assert jax.process_count() == 2

CKPT = os.environ["CDAE_E2E_CKPT"]

# ---- data: config-5-SHAPED formulation at toy scale (CSR streaming +
# packed_io + pooled negatives — the sparse step the huge-catalog regime
# actually runs), split 80/20 per user for a recall@10 gate ----
rng = np.random.default_rng(7)
U, I = 64, 96
pairs = np.unique(rng.integers(0, U * I, 1400))
all_data = Interactions.from_arrays(
    (pairs // I).astype(np.int32), (pairs % I).astype(np.int32),
    num_users=U, num_items=I)
train, val = all_data.split_by_user(0.2, seed=20141119)

# dense_mode pinned OFF: at toy scale the auto heuristic would flip the
# single-process CDAE onto the dense-slab path while ShardedCDAE runs the
# sparse step — different formulations, no trajectory match
cfg = CDAEConfig(num_dim=8, loss="SQUARE", corruption_ratio=0.2, num_neg=2,
                 batch_size=16, neg_pool=128, packed_io=True,
                 stream_batches=True, dense_mode=False)
EPOCHS = 3
key = jax.random.PRNGKey(5)
keys = jax.random.split(key, EPOCHS + 1)


def recall10(params_np):
    params = {k: jnp.asarray(v) for k, v in params_np.items()}
    tcsr = train.csr()
    vcsr = val.csr()
    from cdae_jax.data.dataset import rows_from_csr
    uids = np.arange(U, dtype=np.int32)
    r_items, _, r_mask, _ = rows_from_csr(tcsr, uids, I)
    v_items, _, v_mask, _ = rows_from_csr(vcsr, uids, I)
    scores = _batch_scores(params, jnp.asarray(uids), jnp.asarray(r_items),
                           jnp.asarray(r_mask), cfg=cfg)
    rec, _ = topk_unrated(scores, jnp.asarray(r_items), 10)
    rows = topn_user_metrics(rec, jnp.asarray(v_items), jnp.asarray(v_mask))
    has_val = np.asarray(v_mask).any(axis=1)
    return float(np.asarray(rows)[has_val, 5].mean())  # R@10 column


# ---- single-process baseline (plain CDAE, local device) ----
local = CDAE(cfg)
lstate = local.reset(train, seed=0)
assert lstate.padded is None  # streaming: no full padded matrix
for e in range(EPOCHS):
    lstate = local.train_one_iteration(lstate, keys[e])
local_params = {k: np.asarray(v) for k, v in lstate.params.items()}
local_recall = recall10(local_params)

# ---- 2-process sharded run: same keys, same batch stream ----
mesh = make_mesh(n_data=2, n_model=2)
sh = ShardedCDAE(cfg, mesh=mesh)
sstate = sh.reset(train, seed=0)
for e in range(2):
    sstate = sh.train_one_iteration(sstate, keys[e])

# per-shard checkpoint at epoch 2: every process writes its OWN shards
fp = ckpt.config_fingerprint(sh, sstate)
ckpt.save_sharded(CKPT, sstate, rng_key=keys[2], fingerprint=fp)

# unbroken: epoch 3
sstate = sh.train_one_iteration(sstate, keys[2])

# resumed: fresh state <- per-shard restore -> epoch 3; must be BITWISE
# equal to the unbroken run shard by shard (no host gather anywhere)
sh2 = ShardedCDAE(cfg, mesh=mesh)
rstate = sh2.reset(train, seed=99)
rstate = ckpt.load_sharded(CKPT, rstate, expect_fingerprint=fp)
assert rstate.step == 2
k_resume = ckpt.sharded_rng_key(CKPT)
np.testing.assert_array_equal(np.asarray(k_resume), np.asarray(keys[2]))
rstate = sh2.train_one_iteration(rstate, k_resume)
for k in sstate.params:
    a = {s.device: np.asarray(s.data)
         for s in sstate.params[k].addressable_shards}
    b = {s.device: np.asarray(s.data)
         for s in rstate.params[k].addressable_shards}
    assert a.keys() == b.keys()
    for d in a:
        np.testing.assert_array_equal(a[d], b[d], err_msg=f"{k}@{d}")

# ---- end-to-end parity vs the single-process run ----
gathered = {k: np.asarray(multihost_utils.process_allgather(
                v, tiled=True))
            for k, v in sstate.params.items()}
for k in local_params:
    np.testing.assert_allclose(
        gathered[k], local_params[k], rtol=5e-4, atol=1e-5, err_msg=k)
sh_recall = recall10(gathered)
assert abs(sh_recall - local_recall) <= 0.02, (sh_recall, local_recall)
print(f"proc {jax.process_index()} OK recall_local={local_recall:.4f} "
      f"recall_sharded={sh_recall:.4f}")
"""


def _run_two_procs(tmp_path, worker_src, extra_env=None, timeout=600):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(worker_src)
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            CDAE_COORDINATOR=f"localhost:{port}",
            CDAE_NUM_PROCESSES="2",
            CDAE_PROCESS_ID=str(pid),
            PYTHONPATH=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            JAX_PLATFORMS="cpu",
            **(extra_env or {}),
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "OK" in out
    return outs


@pytest.mark.slow
def test_two_process_collectives(tmp_path):
    _run_two_procs(tmp_path, _WORKER, timeout=300)


@pytest.mark.slow
def test_two_process_e2e_training_and_per_shard_checkpoint(tmp_path):
    """END-TO-END CDAE training across 2 real processes in the config-5
    formulation (CSR streaming + packed_io + neg_pool sparse step) reaches
    the same params (rtol 5e-4) and recall@10 (±0.02) as the single-process
    run; mid-run per-shard orbax checkpoint (each process writes its own
    shards, restore re-shards without host gather) resumes BITWISE equal."""
    _run_two_procs(
        tmp_path, _WORKER_E2E,
        extra_env={"CDAE_E2E_CKPT": str(tmp_path / "shard_ckpt")},
    )


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port
