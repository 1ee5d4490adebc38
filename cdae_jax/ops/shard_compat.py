"""shard_map call shim.

Every shard_map call site in this package goes through here so the repo
tracks the API with one switch; ``check_rep`` maps to jax.shard_map's
``check_vma``.
"""

from __future__ import annotations

import jax


def shard_map(f, *, mesh, in_specs, out_specs, check_rep=True):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=check_rep)
