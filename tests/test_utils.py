"""Profiling utilities tests."""

import jax.numpy as jnp
import numpy as np

from lrcn_jax.utils import StepTimer


def test_step_timer_basic():
    t = StepTimer()
    x = jnp.ones((8, 8))
    for _ in range(3):
        t.start()
        y = x * 2
        t.stop(y)
    assert t.count == 3
    assert t.mean() > 0
    s = t.summary()
    assert s["steps"] == 3 and s["p95_s"] >= s["p50_s"] >= 0
    assert t.throughput(10) > 0


def test_sync_handles_pytrees():
    """StepTimer waits on any pytree of outputs, host arrays included."""
    t = StepTimer()
    t.start({"a": jnp.ones((4,)), "b": [jnp.zeros((2, 2))]})
    assert t.stop(np.ones(3)) >= 0
    assert t.count == 1


def test_measure_device_time():
    """device_time_ms parses the trace's XLA Modules track; the measured
    per-call device time of a compiled matmul is positive and far below
    the traced wall window."""
    import jax
    import jax.numpy as jnp

    from lrcn_jax.utils.profiling import measure_device_time_ms

    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((256, 256), jnp.float32)
    ms = measure_device_time_ms(f, x, iters=4)
    assert ms > 0.0
    assert ms < 1000.0
