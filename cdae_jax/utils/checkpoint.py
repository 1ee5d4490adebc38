"""Model checkpointing — a capability SUPERSET of the reference.

The reference persists only datasets (gzip boost archives,
ref src/base/io/serialize.hpp:16-46); models always retrain from reset
(SURVEY §5 "Checkpoint/resume"). This module adds real model checkpoints:
parameters + optimizer accumulators + step counter. Two formats:

  npz (save_checkpoint/load_checkpoint) — single-host: arrays gathered to
  host, process 0 writes one atomic compressed npz + JSON manifest.

  orbax (save_sharded/load_sharded) — multi-host scale: EVERY process
  writes its own addressable shards (no host gather, no process-0
  full-table materialization) and restore re-shards onto the mesh; the
  rng_key/fingerprint manifest lives in a process-0 sidecar JSON. This is
  the SURVEY §5 "orbax-style sharded arrays + accumulators + RNG state"
  path for the config-5 regime (1M-item tables x D + AdaGrad accumulators
  over N hosts).

Works for every model in the zoo (all states are flat dicts of arrays).
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from typing import Optional

import jax
import numpy as np

from cdae_jax.models.base import ModelState

_FORMAT_VERSION = 2


def config_fingerprint(model, state: ModelState) -> str:
    """Stable hash of (model class, config dataclass, data dims).

    Stored in every checkpoint manifest and verified on load so a resumed
    run cannot silently continue under a different configuration — a
    failure mode the reference cannot have (it never checkpoints models,
    ref src/base/io/serialize.hpp:16-46) but a restartable trainer must
    detect.
    """
    import dataclasses
    import hashlib

    cfg = getattr(model, "cfg", None)
    payload = {
        "model": type(model).__name__,
        "config": dataclasses.asdict(cfg)
        if cfg is not None and dataclasses.is_dataclass(cfg)
        else repr(cfg),
        "num_users": state.num_users,
        "num_items": state.num_items,
    }
    blob = json.dumps(payload, sort_keys=True, default=repr).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_checkpoint(path: str, state: ModelState, extra: Optional[dict] = None,
                    rng_key=None, fingerprint: Optional[str] = None):
    """Atomically persist a ModelState's params + step to ``path``.

    ``rng_key`` (the solver's PRNG stream value entering step+1) and
    ``fingerprint`` (config_fingerprint) make the checkpoint exactly
    resumable: restarting from it replays the identical key sequence the
    unbroken run would have used.
    """
    if jax.process_index() != 0:
        return
    arrays = {k: np.asarray(v) for k, v in state.params.items()}
    manifest = {
        "version": _FORMAT_VERSION,
        "step": state.step,
        "num_users": state.num_users,
        "num_items": state.num_items,
        "param_names": sorted(arrays),
        "extra": extra or {},
    }
    if rng_key is not None:
        manifest["rng_key"] = np.asarray(rng_key).tolist()
    if fingerprint is not None:
        manifest["fingerprint"] = fingerprint
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            with zipfile.ZipFile(f, "w", compression=zipfile.ZIP_DEFLATED) as zf:
                zf.writestr("arrays.npz", buf.getvalue())
                zf.writestr("manifest.json", json.dumps(manifest))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, state: ModelState,
                    expect_fingerprint: Optional[str] = None) -> ModelState:
    """Restore params + step into an existing (reset) ModelState.

    The state must come from ``model.reset`` on the same data so that
    non-array fields (padded views, aux) are already in place. When both
    ``expect_fingerprint`` and the stored fingerprint are present they
    must match — a config/model/data mismatch raises instead of silently
    training a different experiment.
    """
    import jax.numpy as jnp

    with zipfile.ZipFile(path, "r") as zf:
        manifest = json.loads(zf.read("manifest.json"))
        stored_fp = manifest.get("fingerprint")
        if expect_fingerprint and stored_fp and stored_fp != expect_fingerprint:
            raise ValueError(
                f"checkpoint fingerprint {stored_fp} does not match the "
                f"current model/config/data ({expect_fingerprint}); refusing "
                "to resume a different experiment"
            )
        arrs = np.load(io.BytesIO(zf.read("arrays.npz")))
        if manifest["num_users"] != state.num_users or (
            manifest["num_items"] != state.num_items
        ):
            raise ValueError(
                "checkpoint dims "
                f"({manifest['num_users']}x{manifest['num_items']}) do not "
                f"match state ({state.num_users}x{state.num_items})"
            )
        missing = set(manifest["param_names"]) ^ set(state.params)
        if missing:
            raise ValueError(f"param name mismatch: {sorted(missing)}")
        state.params = {k: jnp.asarray(arrs[k]) for k in manifest["param_names"]}
        state.step = int(manifest["step"])
    return state


def checkpoint_extra(path: str) -> dict:
    with zipfile.ZipFile(path, "r") as zf:
        return json.loads(zf.read("manifest.json"))["extra"]


def checkpoint_manifest(path: str) -> dict:
    """Full manifest (step, dims, rng_key, fingerprint, extra)."""
    with zipfile.ZipFile(path, "r") as zf:
        return json.loads(zf.read("manifest.json"))


def checkpoint_rng_key(path: str):
    """The solver PRNG stream value stored at save time (or None)."""
    import jax.numpy as jnp

    key = checkpoint_manifest(path).get("rng_key")
    return None if key is None else jnp.asarray(np.asarray(key, np.uint32))


# ---------------------------------------------------------------- sharded ---
# Orbax-backed checkpoints for mesh-sharded params: every process writes its
# own shards (no host gather), and restore places arrays back onto the mesh
# with their original shardings — the multi-host path the npz format (which
# gathers to process 0) cannot serve.


def save_sharded(path: str, state: ModelState, force: bool = True,
                 rng_key=None, fingerprint: Optional[str] = None,
                 extra: Optional[dict] = None) -> None:
    """Persist a (possibly sharded) ModelState via orbax PyTree checkpoint.

    EVERY process calls this: orbax writes only each process's addressable
    shards (no host gather, no process-0 full-table materialization — the
    multi-host path SURVEY §5's checkpoint spec requires). ``rng_key`` /
    ``fingerprint`` / ``extra`` land in a process-0 sidecar manifest so a
    sharded checkpoint is exactly resumable like the npz format.
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(
            path,
            {"params": state.params,
             "meta": {"step": state.step,
                      "num_users": state.num_users,
                      "num_items": state.num_items}},
            force=force,
        )
    if jax.process_index() == 0:
        manifest = {"version": _FORMAT_VERSION, "step": state.step,
                    "extra": extra or {}}
        if rng_key is not None:
            manifest["rng_key"] = np.asarray(rng_key).tolist()
        if fingerprint is not None:
            manifest["fingerprint"] = fingerprint
        with open(os.path.join(path, "cdae_manifest.json"), "w") as f:
            json.dump(manifest, f)


def sharded_manifest(path: str) -> dict:
    """The sidecar manifest of a sharded checkpoint (rng_key, fingerprint,
    step, extra) — {} for checkpoints written before the manifest existed."""
    p = os.path.join(os.path.abspath(path), "cdae_manifest.json")
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def sharded_rng_key(path: str):
    """The solver PRNG stream value stored at save time (or None)."""
    import jax.numpy as jnp

    key = sharded_manifest(path).get("rng_key")
    return None if key is None else jnp.asarray(np.asarray(key, np.uint32))


def load_sharded(path: str, state: ModelState,
                 expect_fingerprint: Optional[str] = None) -> ModelState:
    """Restore into a reset ModelState, preserving each param's sharding.

    Each process reads back only its own shards (orbax re-shards onto the
    abstract shardings taken from ``state.params``); no full-table host
    materialization. With ``expect_fingerprint`` the sidecar manifest's
    fingerprint must match (same refusal semantics as load_checkpoint).

    Note: orbax requires sharded dims divisible by the mesh axis size (pad
    user/item counts to mesh multiples for uneven tables; the npz format has
    no such constraint single-host).
    """
    import jax
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    stored_fp = sharded_manifest(path).get("fingerprint")
    if expect_fingerprint and stored_fp and stored_fp != expect_fingerprint:
        raise ValueError(
            f"checkpoint fingerprint {stored_fp} does not match the "
            f"current model/config/data ({expect_fingerprint}); refusing "
            "to resume a different experiment"
        )
    abstract = {
        "params": {
            k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=v.sharding)
            for k, v in state.params.items()
        },
        "meta": {"step": 0, "num_users": 0, "num_items": 0},
    }
    with ocp.PyTreeCheckpointer() as ckptr:
        restored = ckptr.restore(
            path, args=ocp.args.PyTreeRestore(
                item=abstract,
                restore_args=ocp.checkpoint_utils.construct_restore_args(
                    abstract
                ),
            )
        )
    meta = restored["meta"]
    if (meta["num_users"] != state.num_users
            or meta["num_items"] != state.num_items):
        raise ValueError(
            f"checkpoint dims ({meta['num_users']}x{meta['num_items']}) do "
            f"not match state ({state.num_users}x{state.num_items})"
        )
    state.params = restored["params"]
    state.step = int(meta["step"])
    return state
