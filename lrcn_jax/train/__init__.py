from lrcn_jax.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from lrcn_jax.train.joint import JointTrainer  # noqa: F401
from lrcn_jax.train.metrics import MetricsLogger  # noqa: F401
from lrcn_jax.train.trainer import Trainer  # noqa: F401
