"""Joint CNN+LSTM fine-tune throughput (the paper's LRCN-2f setup).

Full end-to-end step: uint8 images -> on-device mean-subtract -> VGG-16
fc7 (jax.checkpoint remat) -> L1-normalize -> decoder loss -> grads for
BOTH param sets -> dual-lr Adam.  Measures:

- single-step dispatch wall;
- K-steps-per-dispatch scanned wall (the same amortization as the
  decoder trainer's scanned steps);
- device time of the scanned program (utils/profiling), so the wall /
  device gap is recorded rather than inferred.

Run on the GPU; each timed region ends when its scalar result reaches
the host.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np

from lrcn_jax.config import LRCNConfig
from lrcn_jax.models import vgg
from lrcn_jax.models.joint import JointTrainStep, make_joint_optimizer
from lrcn_jax.utils.profiling import measure_device_time_ms

cfg = LRCNConfig(hidden=(1000, 1000), embed=1000, vocab_size=8800,
                 dropout=0.4)
avg = np.full((224, 224, 3), 117.0, np.float32)
step = JointTrainStep(cfg, make_joint_optimizer(cfg), average_image=avg)
params, opt_state = step.init(
    jax.random.PRNGKey(0), vgg_params=vgg.init_vgg_params(
        jax.random.PRNGKey(1)))

B, L, K = 128, 20, 4
rng = np.random.default_rng(0)
images = rng.integers(0, 256, (B, 224, 224, 3)).astype(np.uint8)
tokens = rng.integers(3, cfg.vocab_size, (B, L)).astype(np.int32)
lengths = rng.integers(10, L + 1, (B,)).astype(np.int32)
dev = step.shard_batch(images, tokens, lengths)
key = jax.random.PRNGKey(2)

# --- single dispatch per step (round-2 baseline path) ---
params, opt_state, loss = step(params, opt_state, *dev, key)
float(loss)  # compile + sync
n = 5
t0 = time.perf_counter()
for i in range(n):
    params, opt_state, loss = step(params, opt_state, *dev,
                                   jax.random.fold_in(key, i))
float(loss)
dt = (time.perf_counter() - t0) / n
print(f"joint single-step B={B}: {dt*1e3:.1f} ms wall -> "
      f"{B/dt:.0f} images/s")

# --- K steps per dispatch (scanned) ---
chunk = step.shard_chunk(
    np.broadcast_to(images, (K,) + images.shape).copy(),
    np.broadcast_to(tokens, (K,) + tokens.shape).copy(),
    np.broadcast_to(lengths, (K,) + lengths.shape).copy())
params, opt_state, losses = step.multi_step(params, opt_state, *chunk,
                                            key, 0)
float(losses[-1])  # compile + sync
t0 = time.perf_counter()
for i in range(n):
    params, opt_state, losses = step.multi_step(params, opt_state, *chunk,
                                                key, i * K)
float(losses[-1])
dt_k = (time.perf_counter() - t0) / n
print(f"joint K={K} scan B={B}: {dt_k*1e3:.1f} ms wall / dispatch -> "
      f"{K*B/dt_k:.0f} images/s")

# --- device time of the scanned program (non-donating compile: the
# profiler re-runs the same buffers) ---
plain = jax.jit(step._multi_step_impl)
ms = measure_device_time_ms(plain, params, opt_state, *chunk, key,
                            np.int32(0))
print(f"joint K={K} scan device time: {ms:.1f} ms / dispatch -> "
      f"{K*B/(ms/1e3):.0f} images/s device "
      f"({100*ms/(dt_k*1e3):.0f}% of wall)")

# --- no-remat variant (--no-remat-cnn): 3x instead of 4x forward FLOPs,
# at the cost of holding one microbatch's conv activations in HBM ---
step_nr = JointTrainStep(cfg, make_joint_optimizer(cfg),
                         average_image=avg, remat_cnn=False)
params, opt_state = step_nr.init(
    jax.random.PRNGKey(0), vgg_params=vgg.init_vgg_params(
        jax.random.PRNGKey(1)))
params, opt_state, losses = step_nr.multi_step(params, opt_state, *chunk,
                                               key, 0)
float(losses[-1])
t0 = time.perf_counter()
for i in range(n):
    params, opt_state, losses = step_nr.multi_step(
        params, opt_state, *chunk, key, i * K)
float(losses[-1])
dt_nr = (time.perf_counter() - t0) / n
print(f"joint K={K} scan, no remat: {dt_nr*1e3:.1f} ms / dispatch -> "
      f"{K*B/dt_nr:.0f} images/s")
