from lrcn_jax.utils.profiling import StepTimer, trace

__all__ = ["StepTimer", "trace"]
