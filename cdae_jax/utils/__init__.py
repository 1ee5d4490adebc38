from cdae_jax.utils.timer import Timer
from cdae_jax.utils.logging import get_logger

__all__ = ["Timer", "get_logger"]
