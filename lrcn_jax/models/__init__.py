from lrcn_jax.models import lrcn  # noqa: F401
