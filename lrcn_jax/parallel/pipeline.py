"""Pipeline parallelism for the LRCN decoder.

The reference is single-GPU (SURVEY.md §2 parallelism table: PP "No"); its
survey notes the natural 2-stage split of this model.  A transformer-style
microbatch pipeline is a poor fit for a recurrent decoder — but the
recurrence itself pipelines: teacher forcing makes every LSTM-1 input
known upfront, so **stage 0 computes h1(t) while stage 1 computes h2(t-1)**
on a different chip, every tick.  The pipeline "microbatch" is the
timestep; the fill/drain bubble is ONE tick regardless of sequence length
(efficiency T/(T+1), ~96% at the 28-token cap).

Mesh layout: ``('data', 'model')`` with the ``model`` axis of size 2 doing
double duty —

- **during the recurrence** it is the pipeline-stage axis: each device
  holds exactly one LSTM layer's weights (stacked leading axis sharded
  over ``model``), h1 activations hop stage 0 -> stage 1 over the device interconnect via
  ``ppermute`` each tick;
- **at the ends** it is the vocabulary tensor-parallel axis: the embedding
  table and the output projection shard their vocab dimension over it, the
  log-softmax normalizer and gold-logit gather reduce with ``psum``.

Everything lives in ONE ``shard_map``-ed jitted program; ``jax.grad``
differentiates through the collectives (ppermute transposes to the reverse
permutation, replicated-in params transpose to psum).

Shape requirements (asserted): H1 == H2 == E with H2 even, so both stages
run the same (2H, 4H) cell program — SPMD with heterogeneous per-stage
shapes would force both layers onto both chips.  The reference defaults
(hidden=[1000,1000], embed=1000, lrcn.jl:39-40) satisfy this.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lrcn_jax.config import LRCNConfig
from lrcn_jax.models import lrcn
from lrcn_jax.ops.lstm import lstm_step, matmul

N_STAGES = 2  # the factored LRCN decoder has exactly 2 LSTM layers


def validate_pipeline_config(cfg: LRCNConfig, mesh: Mesh) -> None:
    h1, h2 = cfg.hidden
    if mesh.shape.get("model", 1) != N_STAGES:
        raise ValueError(
            f"pipeline parallelism uses a 'model' mesh axis of exactly "
            f"{N_STAGES} (one device group per LSTM layer); got "
            f"{mesh.shape.get('model', 1)}")
    if not (h1 == h2 == cfg.embed and h2 % 2 == 0):
        raise ValueError(
            f"pipeline parallelism requires hidden1 == hidden2 == embed "
            f"with an even hidden size so both stages run one uniform cell "
            f"program; got hidden={cfg.hidden}, embed={cfg.embed} "
            f"(the reference defaults 1000/1000/1000 qualify)")
    if cfg.vocab_size % N_STAGES:
        raise ValueError(
            f"vocab_size={cfg.vocab_size} must be divisible by {N_STAGES} "
            f"for the vocab-TP softmax on the same axis")


def to_pipeline_params(params: lrcn.Params) -> dict[str, Any]:
    """Standard decoder pytree -> pipeline layout (stages stacked)."""
    out = {k: v for k, v in params.items()
           if k not in ("lstm1", "lstm2")}
    out["lstm_pp"] = {
        "w": jnp.stack([params["lstm1"]["w"], params["lstm2"]["w"]]),
        "b": jnp.stack([params["lstm1"]["b"], params["lstm2"]["b"]]),
    }
    return out


def from_pipeline_params(pp_params: dict[str, Any]) -> lrcn.Params:
    """Pipeline layout -> standard decoder pytree (for checkpoints/decode)."""
    out = {k: v for k, v in pp_params.items() if k != "lstm_pp"}
    w = jnp.asarray(pp_params["lstm_pp"]["w"])
    b = jnp.asarray(pp_params["lstm_pp"]["b"])
    out["lstm1"] = {"w": w[0], "b": b[0]}
    out["lstm2"] = {"w": w[1], "b": b[1]}
    return out


PIPELINE_PARAM_SPECS: dict[str, Any] = {
    "lstm_pp": {"w": P("model", None, None), "b": P("model", None)},
    "w_factor": P(),
    "w_cnn": P(),
    "embedding": P("model", None),
    "w_out": P(None, "model"),
    "b_out": P("model"),
}


def pipeline_param_sharding(mesh: Mesh) -> dict[str, Any]:
    return jax.tree.map(lambda s: NamedSharding(mesh, s),
                        PIPELINE_PARAM_SPECS,
                        is_leaf=lambda x: isinstance(x, P))


def _pipeline_body(embeds_pad, mask2_shift, cnn_proj, targets_t, mask_t,
                   w_pp, b_pp, w_factor, w_out, b_out, *, compute_dtype):
    """Per-device program: pipelined recurrence + vocab-TP masked NLL.

    Runs under shard_map; the batch dim is already the local 'data' shard
    and w_pp/b_pp/w_out/b_out are the local stage/vocab slices.
    """
    stage = jax.lax.axis_index("model")
    w, b = w_pp[0], b_pp[0]                      # this stage's cell
    t1, b_dim, e_dim = embeds_pad.shape          # t1 = T + 1 ticks
    h_dim = w.shape[1] // 4
    state = (jnp.zeros((b_dim, h_dim), jnp.float32),
             jnp.zeros((b_dim, h_dim), jnp.float32),
             jnp.zeros((b_dim, h_dim), jnp.float32))  # h, c, recv buffer

    def tick(carry, xs):
        h, c, buf = carry
        k, x_embed, m2 = xs
        # stage-1 input: factor-projected h1 from the PREVIOUS tick,
        # concatenated with the CNN projection (lrcn.jl:545-546); the
        # visual input is re-injected every step.
        h1f = matmul(buf, w_factor, compute_dtype)
        x2 = jnp.concatenate([h1f, cnn_proj], axis=-1)
        if m2 is not None:
            x2 = x2 * m2                          # lrcn.jl:547 dropout
        x = jnp.where(stage == 0, x_embed, x2)    # E == 2F: same width
        h_new, c_new = lstm_step(w, b, h, c, x, compute_dtype=compute_dtype)
        # A stage's recurrence starts at tick == stage: during its fill
        # tick(s) the state must STAY zero (the reference starts every
        # layer from a zero state, lrcn.jl:512-526), not absorb the
        # garbage flowing through the empty pipeline.
        valid = k >= stage
        h = jnp.where(valid, h_new, h)
        c = jnp.where(valid, c_new, c)
        # h1 hops to stage 1 over the interconnect; stage 0's buffer refills with zeros
        send = jax.lax.ppermute(h, "model", [(0, 1)])
        return (h, c, send), h

    _, ys = jax.lax.scan(
        tick, state, (jnp.arange(t1), embeds_pad, mask2_shift))
    # stage 1's ys[k] is h2(k-1); broadcast it so BOTH devices join the
    # vocab-TP softmax (stage 0 is otherwise idle during the loss).
    recv_ys = jax.lax.ppermute(ys, "model", [(1, 0)])
    h2_seq = jnp.where(stage == 1, ys, recv_ys)[1:]          # (T, B, H)

    t_dim = t1 - 1
    tgt_flat = targets_t.reshape(t_dim * b_dim)
    mask_flat = mask_t.reshape(t_dim * b_dim).astype(jnp.float32)
    logits = (matmul(h2_seq.reshape(t_dim * b_dim, h_dim), w_out,
                     compute_dtype)
              + b_out.astype(jnp.float32))                   # (T*B, V/2)
    # numerically-stable log-softmax over the SHARDED vocab axis
    # (stop_gradient INSIDE pmax: pmax has no differentiation rule, and
    # the shift constant carries no gradient anyway)
    m = jax.lax.pmax(
        jnp.max(jax.lax.stop_gradient(logits), axis=-1), "model")
    z = jax.lax.psum(jnp.sum(jnp.exp(logits - m[:, None]), axis=-1),
                     "model")
    logz = jnp.log(z) + m
    # gold logit: each device gathers targets that land in its vocab shard
    v_local = logits.shape[-1]
    local_idx = tgt_flat - stage * v_local
    in_shard = (local_idx >= 0) & (local_idx < v_local)
    gold_local = jnp.take_along_axis(
        logits, jnp.clip(local_idx, 0, v_local - 1)[:, None], axis=1)[:, 0]
    gold = jax.lax.psum(jnp.where(in_shard, gold_local, 0.0), "model")
    nll = (logz - gold) * mask_flat
    total = jax.lax.psum(jnp.sum(nll), "data")
    count = jax.lax.psum(jnp.sum(mask_flat), "data")
    return total, count


def pipeline_loss_total_count(pp_params: dict[str, Any], tokens: jax.Array,
                              lengths: jax.Array, feats: jax.Array,
                              mesh: Mesh, *, pdrop: float = 0.0,
                              rng: jax.Array | None = None,
                              compute_dtype=jnp.bfloat16
                              ) -> tuple[jax.Array, jax.Array]:
    """Summed NLL + prediction count, pipelined over the mesh.

    Semantics identical to ``lrcn.loss_total_count`` (teacher forcing with
    the extra EOS step, lrcn.jl:553-579; masked padding) — the parity test
    asserts equality against the single-device loss.
    """
    inputs, targets, mask = lrcn.build_teacher_forcing(tokens, lengths)
    b_dim, t_dim = inputs.shape

    embeds = pp_params["embedding"][inputs]        # TP gather (GSPMD)
    embeds = jnp.transpose(embeds, (1, 0, 2)).astype(jnp.float32)

    mask2_shift = None
    if pdrop > 0.0:
        if rng is None:
            raise ValueError("dropout requires an rng key")
        k1, k2 = jax.random.split(rng)
        keep = 1.0 - pdrop
        # identical mask construction to lrcn.loss_total_count
        embeds = embeds * (
            jax.random.bernoulli(k1, keep, embeds.shape) / keep)
        f2 = 2 * pp_params["w_factor"].shape[-1]
        drop_mask2 = (
            jax.random.bernoulli(k2, keep, (t_dim, b_dim, f2)) / keep
        ).astype(jnp.float32)
        # stage 1 consumes step k-1's input at tick k: shift by one tick
        mask2_shift = jnp.concatenate(
            [jnp.ones((1, b_dim, f2), jnp.float32), drop_mask2], axis=0)

    # one zero-padded trailing tick drains the pipeline
    embeds_pad = jnp.concatenate(
        [embeds, jnp.zeros((1,) + embeds.shape[1:], embeds.dtype)], axis=0)
    cnn_proj = lrcn.cnn_projection(pp_params, feats, compute_dtype)
    targets_t = jnp.transpose(targets)              # (T, B) time-major
    mask_t = jnp.transpose(mask)

    body = functools.partial(_pipeline_body, compute_dtype=compute_dtype)
    total, count = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, "data", None),            # embeds_pad
                  (P(None, "data", None) if mask2_shift is not None
                   else None),                      # dropout mask
                  P("data", None),                  # cnn_proj
                  P(None, "data"),                  # targets (time-major)
                  P(None, "data"),                  # loss mask
                  P("model", None, None), P("model", None),  # cell weights
                  P(), P(None, "model"), P("model")),
        out_specs=(P(), P()),
        check_vma=False,
    )(embeds_pad, mask2_shift, cnn_proj, targets_t, mask_t,
      pp_params["lstm_pp"]["w"], pp_params["lstm_pp"]["b"],
      pp_params["w_factor"], pp_params["w_out"], pp_params["b_out"])
    return total, count


def pipeline_loss_fn(pp_params, tokens, lengths, feats, mesh, *,
                     pdrop: float = 0.0, rng: jax.Array | None = None,
                     compute_dtype=jnp.bfloat16) -> jax.Array:
    total, count = pipeline_loss_total_count(
        pp_params, tokens, lengths, feats, mesh, pdrop=pdrop, rng=rng,
        compute_dtype=compute_dtype)
    return total / count


class PipelinedTrainStep:
    """Jitted DP x (PP+vocab-TP) train step.

    Same host-facing API as ``ShardedTrainStep``; params live in the
    pipeline layout (``to_pipeline_params``/``from_pipeline_params``
    convert to/from the standard decoder pytree for checkpoints/decoding).
    """

    def __init__(self, cfg: LRCNConfig, opt: optax.GradientTransformation,
                 mesh: Mesh):
        validate_pipeline_config(cfg, mesh)
        self.cfg = cfg
        self.opt = opt
        self.mesh = mesh
        self._compute_dtype = jnp.dtype(cfg.compute_dtype)
        rep = NamedSharding(mesh, P())
        self._step = jax.jit(
            functools.partial(self._step_impl, pdrop=cfg.dropout),
            out_shardings=(None, None, rep), donate_argnums=(0, 1))
        self._eval = jax.jit(self._eval_impl, out_shardings=(rep, rep))

    def _step_impl(self, pp_params, opt_state, tokens, lengths, feats, rng,
                   pdrop):
        def loss(p):
            return pipeline_loss_fn(p, tokens, lengths, feats, self.mesh,
                                    pdrop=pdrop, rng=rng,
                                    compute_dtype=self._compute_dtype)
        loss_val, grads = jax.value_and_grad(loss)(pp_params)
        updates, opt_state = self.opt.update(grads, opt_state, pp_params)
        return optax.apply_updates(pp_params, updates), opt_state, loss_val

    def _eval_impl(self, pp_params, tokens, lengths, feats):
        return pipeline_loss_total_count(
            pp_params, tokens, lengths, feats, self.mesh, pdrop=0.0,
            compute_dtype=self._compute_dtype)

    # --- host-facing API (mirrors ShardedTrainStep) ---

    def shard_params(self, params: lrcn.Params) -> dict[str, Any]:
        return jax.device_put(to_pipeline_params(params),
                              pipeline_param_sharding(self.mesh))

    def unshard_params(self, pp_params) -> lrcn.Params:
        return from_pipeline_params(jax.device_get(pp_params))

    def init_opt(self, pp_params):
        from lrcn_jax.parallel.train import place_opt_state
        return place_opt_state(self.opt.init(pp_params),
                               pipeline_param_sharding(self.mesh),
                               self.mesh)

    def shard_batch(self, tokens, lengths, feats):
        from lrcn_jax.parallel.train import put_batch
        return put_batch(self.mesh, tokens, lengths, feats)

    def __call__(self, pp_params, opt_state, tokens, lengths, feats, rng):
        return self._step(pp_params, opt_state, tokens, lengths, feats, rng)

    def eval_batch(self, pp_params, tokens, lengths, feats):
        return self._eval(pp_params, tokens, lengths, feats)
