"""VGG-16 fc7 throughput: per-batch dispatch vs one scanned dispatch.

Run on the GPU; each timed region ends when its scalar result reaches
the host.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np

from lrcn_jax.models import vgg

params = jax.device_put(vgg.init_vgg_params(jax.random.PRNGKey(0)))
rng = np.random.default_rng(0)

# per-batch dispatch (one jit call per batch, pipelined)
for B in (64, 128, 256):
    imgs = jnp.asarray(rng.standard_normal((B, 224, 224, 3)), jnp.float32)
    f = jax.jit(lambda p, x: vgg.vgg16_fc7(p, x, jnp.bfloat16).sum())
    float(f(params, imgs))  # compile+run
    n = 5
    t0 = time.perf_counter()
    outs = [f(params, imgs) for _ in range(n)]
    float(outs[-1])
    dt = (time.perf_counter() - t0) / n
    print(f"per-batch B={B}: {dt*1e3:.1f} ms/batch -> {B/dt:.0f} images/s")

# one scanned dispatch of K batches
K, B = 8, 256
stacked = jnp.asarray(rng.standard_normal((K, B, 224, 224, 3)),
                      jnp.bfloat16)
g = jax.jit(lambda p, x: vgg.vgg16_fc7_scan(p, x).sum())
float(g(params, stacked))
n = 3
t0 = time.perf_counter()
outs = [g(params, stacked) for _ in range(n)]
float(outs[-1])
dt = (time.perf_counter() - t0) / (n * K)
print(f"scan-of-{K} B={B}: {dt*1e3:.1f} ms/batch -> {B/dt:.0f} images/s")
