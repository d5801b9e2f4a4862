"""Fused LSTM primitives.

The reference cell (lrcn.jl:528-538) computes one fused 4-gate matmul
``hcat(input, hidden) * W .+ b`` and slices gates in the order
[forget, ingate, outgate, change].  We keep the same packed weight layout
``W[(X+H), 4H]`` and gate order (so shape parity with the reference is
line-for-line checkable) but split the matmul into ``x @ Wx + h @ Wh`` so the
input half can be hoisted out of the recurrence:

- For layer 1 the entire input projection for all timesteps is one large
  ``(T*B, E) @ (E, 4H)`` matmul computed before the ``lax.scan``; the
  scan body only does the ``h @ Wh`` recurrent matmul.
- Gate nonlinearities and the cell update are elementwise work that XLA
  fuses around the matmul.

Matmuls run in bfloat16 with float32 accumulation; the cell state stays
float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def matmul(a: jax.Array, w: jax.Array,
           compute_dtype: jnp.dtype = jnp.bfloat16) -> jax.Array:
    """Matmul: cast operands to ``compute_dtype``, accumulate in f32.

    When ``compute_dtype`` is float32 we request HIGHEST precision — by
    default a GPU computes f32 dots in TF32, which would defeat the point
    of an explicit f32 compute path (used by numerical parity tests and the
    VGG fc7 parity check).
    """
    precision = (jax.lax.Precision.HIGHEST
                 if jnp.dtype(compute_dtype) == jnp.float32 else None)
    return jnp.dot(a.astype(compute_dtype), w.astype(compute_dtype),
                   preferred_element_type=jnp.float32, precision=precision)


def lstm_cell_update(gates: jax.Array, c: jax.Array
                     ) -> tuple[jax.Array, jax.Array]:
    """Apply gate nonlinearities + cell update to pre-activation gates.

    ``gates`` has shape (..., 4H) packed [forget, ingate, outgate, change]
    (reference gate order, lrcn.jl:531-534).  Returns (h, c), both float32.
    """
    h_dim = c.shape[-1]
    gates = gates.astype(jnp.float32)
    f = jax.nn.sigmoid(gates[..., :h_dim])
    i = jax.nn.sigmoid(gates[..., h_dim:2 * h_dim])
    o = jax.nn.sigmoid(gates[..., 2 * h_dim:3 * h_dim])
    g = jnp.tanh(gates[..., 3 * h_dim:])
    c = c * f + i * g                      # lrcn.jl:535
    h = o * jnp.tanh(c)                    # lrcn.jl:536
    return h, c


def lstm_step(w: jax.Array, b: jax.Array, h: jax.Array, c: jax.Array,
              x: jax.Array, *,
              compute_dtype: jnp.dtype = jnp.bfloat16
              ) -> tuple[jax.Array, jax.Array]:
    """One full LSTM step with packed weights ``w[(X+H), 4H]``, bias ``b[4H]``.

    Equivalent to the reference's ``hcat(input,hidden) * weight .+ bias``
    (lrcn.jl:529) followed by the gate update.
    """
    x_dim = x.shape[-1]
    gates = (matmul(x, w[:x_dim], compute_dtype)
             + matmul(h, w[x_dim:], compute_dtype)
             + b.astype(jnp.float32))
    return lstm_cell_update(gates, c)


def lstm_recurrent_gates(w: jax.Array, b: jax.Array, h: jax.Array,
                         x_proj: jax.Array, x_dim: int, *,
                         compute_dtype: jnp.dtype = jnp.bfloat16
                         ) -> jax.Array:
    """Gates from a precomputed input projection plus the recurrent matmul.

    ``x_proj`` is ``x @ w[:x_dim]`` hoisted out of the scan; this adds
    ``h @ w[x_dim:] + b``.
    """
    return (x_proj
            + matmul(h, w[x_dim:], compute_dtype)
            + b.astype(jnp.float32))
