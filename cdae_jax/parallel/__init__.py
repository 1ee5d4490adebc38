from cdae_jax.parallel.mesh import make_mesh, cdae_param_specs, batch_specs
from cdae_jax.parallel.topk import distributed_topk_unrated

__all__ = [
    "make_mesh",
    "cdae_param_specs",
    "batch_specs",
    "distributed_topk_unrated",
    "ShardedCDAE",
    "ShardedIMF",
    "ShardedPairwise",
    "ShardedNegMF",
    "ShardedFISM",
    "ShardedALS",
    "ShardedWRMF",
    "ShardedMFTP",
    "ShardedPairwiseTP",
]


def __getattr__(name):  # lazy: trainer pulls in the model zoo
    if name in ("ShardedCDAE", "ShardedIMF", "ShardedPairwise",
                "ShardedNegMF", "ShardedFISM", "ShardedALS", "ShardedWRMF"):
        from cdae_jax.parallel import trainer

        return getattr(trainer, name)
    if name in ("ShardedMFTP", "ShardedPairwiseTP"):
        from cdae_jax.parallel import tp_pairwise

        return getattr(tp_pairwise, name)
    raise AttributeError(name)
