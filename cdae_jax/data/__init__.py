from cdae_jax.data.vocab import Vocab
from cdae_jax.data.dataset import Interactions, PaddedUserBatch
from cdae_jax.data import io

__all__ = ["Vocab", "Interactions", "PaddedUserBatch", "io"]
