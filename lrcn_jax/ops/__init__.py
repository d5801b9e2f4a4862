from lrcn_jax.ops.lstm import (  # noqa: F401
    lstm_cell_update,
    lstm_step,
    matmul,
)
