import jax, jax.numpy as jnp, numpy as np, time, functools, optax
from lrcn_jax.config import LRCNConfig
from lrcn_jax.models import lrcn
from lrcn_jax.train.trainer import make_optimizer

cfg = LRCNConfig(hidden=(1000,1000), embed=1000, vocab_size=8800, dropout=0.4)
params = jax.device_put(lrcn.init_params(jax.random.PRNGKey(0), cfg))
opt = make_optimizer(cfg)
opt_state = opt.init(params)

B, L = 256, 20
rng = np.random.default_rng(0)
tokens = jnp.asarray(rng.integers(3, cfg.vocab_size, (B, L)), jnp.int32)
lengths = jnp.asarray(rng.integers(10, L+1, (B,)), jnp.int32)
feats = jnp.asarray(rng.standard_normal((B, 4096)), jnp.float32)

@functools.partial(jax.jit, donate_argnums=(0,1))
def step(params, opt_state, rng):
    loss, grads = jax.value_and_grad(lrcn.loss_fn)(params, tokens, lengths, feats, pdrop=0.4, rng=rng)
    updates, opt_state = opt.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss

k = jax.random.PRNGKey(1)
params, opt_state, loss = step(params, opt_state, k)
float(loss)  # sync
n = 20
t0 = time.perf_counter()
for i in range(n):
    params, opt_state, loss = step(params, opt_state, jax.random.fold_in(k, i))
print("final loss", float(loss))
dt = time.perf_counter() - t0
words = int(jnp.sum(lengths)) * n
print(f"train: {n} steps in {dt:.3f}s -> {words/dt:.0f} words/s, {n*B/dt:.0f} captions/s")
