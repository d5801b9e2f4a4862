"""Multi-device sharding tests on a virtual 8-device CPU mesh.

The reference has no distributed anything (SURVEY.md §2, parallelism table);
these tests validate the pure-addition DP/TP path: correctness vs. the
single-device trainer and param-sync invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from lrcn_jax.config import LRCNConfig
from lrcn_jax.models import lrcn
from lrcn_jax.parallel import ShardedTrainStep, make_mesh, shard_params
from lrcn_jax.train.trainer import Trainer, make_optimizer


def small_cfg(**kw):
    base = dict(hidden=(32, 32), embed=24, cnn_feature_dim=64, vocab_size=48,
                batch_size=8, dropout=0.0, compute_dtype="float32", seed=7)
    base.update(kw)
    return LRCNConfig(**base)


def make_batch(cfg, rng, batch=8, length=7):
    tokens = rng.integers(3, cfg.vocab_size, (batch, length)).astype(np.int32)
    lengths = rng.integers(3, length + 1, (batch,)).astype(np.int32)
    feats = rng.standard_normal(
        (batch, cfg.cnn_feature_dim)).astype(np.float32)
    return tokens, lengths, feats


def test_make_mesh_wildcard():
    mesh = make_mesh((-1, 2))
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError):
        make_mesh((16, 1))


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_step_matches_single_device(mesh_shape):
    """DP/TP sharded step computes the same loss+params as one device."""
    cfg = small_cfg()
    rng = np.random.default_rng(0)
    tokens, lengths, feats = make_batch(cfg, rng)
    key = jax.random.PRNGKey(1)
    step_key = jax.random.PRNGKey(2)

    # single-device reference
    trainer = Trainer(cfg, vocab=None)
    params0, opt0 = trainer.init(key)
    p1, o1, loss1 = trainer._train_step(
        jax.tree.map(jnp.copy, params0), jax.tree.map(jnp.copy, opt0),
        jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(feats),
        step_key)

    mesh = make_mesh(mesh_shape)
    sstep = ShardedTrainStep(cfg, make_optimizer(cfg), mesh)
    sp = sstep.shard_params(params0)
    so = sstep.init_opt(sp)
    p2, o2, loss2 = sstep(sp, so, *sstep.shard_batch(tokens, lengths, feats),
                          step_key)

    assert np.allclose(float(loss1), float(loss2), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-6)


def test_param_shardings_are_applied():
    cfg = small_cfg()
    mesh = make_mesh((4, 2))
    params = shard_params(
        lrcn.init_params(jax.random.PRNGKey(0), cfg), mesh)
    assert params["w_out"].sharding.is_equivalent_to(
        NamedSharding(mesh, P(None, "model")), 2)
    assert params["embedding"].sharding.is_equivalent_to(
        NamedSharding(mesh, P("model", None)), 2)
    assert params["lstm1"]["w"].sharding.is_equivalent_to(
        NamedSharding(mesh, P()), 2)


def test_opt_state_inherits_sharding():
    cfg = small_cfg()
    mesh = make_mesh((4, 2))
    sstep = ShardedTrainStep(cfg, make_optimizer(cfg), mesh)
    params = sstep.shard_params(
        lrcn.init_params(jax.random.PRNGKey(0), cfg))
    opt_state = sstep.init_opt(params)
    mus = [s for s in jax.tree.leaves(opt_state)
           if hasattr(s, "sharding") and s.ndim == 2
           and s.shape == params["w_out"].shape]
    assert mus, "expected Adam moments shaped like w_out"
    for m in mus:
        assert m.sharding.is_equivalent_to(
            NamedSharding(mesh, P(None, "model")), 2)


def test_multi_step_training_reduces_loss():
    cfg = small_cfg(lr=1e-2)
    rng = np.random.default_rng(3)
    tokens, lengths, feats = make_batch(cfg, rng, batch=16)
    mesh = make_mesh((4, 2))
    sstep = ShardedTrainStep(cfg, make_optimizer(cfg), mesh)
    params = sstep.shard_params(
        lrcn.init_params(jax.random.PRNGKey(0), cfg))
    opt_state = sstep.init_opt(params)
    batch = sstep.shard_batch(tokens, lengths, feats)
    losses = []
    key = jax.random.PRNGKey(9)
    for _ in range(30):
        key, sk = jax.random.split(key)
        params, opt_state, loss = sstep(params, opt_state, *batch, sk)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::10]
    total, count = sstep.eval_batch(params, *batch)
    assert float(total) / float(count) < losses[0]


def test_host_local_batch_single_process():
    from lrcn_jax.parallel.distributed import host_local_batch, initialize
    initialize()  # no-op single-process
    mesh = make_mesh((8, 1))
    batch = {"tokens": np.arange(32).reshape(8, 4),
             "lengths": np.ones(8, np.int32)}
    out = host_local_batch(mesh, batch)
    assert out["tokens"].shape == (8, 4)
    assert out["tokens"].sharding.is_equivalent_to(
        NamedSharding(mesh, P("data")), 2)
    np.testing.assert_array_equal(np.asarray(out["tokens"]),
                                  batch["tokens"])


def test_sharded_beam_search_matches_single_device():
    from lrcn_jax.parallel.decode import sharded_beam_search
    cfg = small_cfg()
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((16, cfg.cnn_feature_dim)).astype(np.float32)

    from lrcn_jax.decode.beam import beam_search
    ref_tok, ref_scores = beam_search(params, jnp.asarray(feats),
                                      beam_width=3, max_words=8,
                                      compute_dtype=jnp.float32)
    mesh = make_mesh((8, 1))
    tok, scores = sharded_beam_search(params, feats, mesh, beam_width=3,
                                      max_words=8,
                                      compute_dtype=jnp.float32)
    assert tok.sharding.is_fully_addressable
    np.testing.assert_array_equal(np.asarray(tok), np.asarray(ref_tok))
    np.testing.assert_allclose(np.asarray(scores), np.asarray(ref_scores),
                               rtol=1e-5)


def test_sharded_greedy_search_runs():
    from lrcn_jax.parallel.decode import sharded_beam_search
    cfg = small_cfg()
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    feats = np.random.default_rng(2).standard_normal(
        (8, cfg.cnn_feature_dim)).astype(np.float32)
    mesh = make_mesh((8, 1))
    tok, scores = sharded_beam_search(params, feats, mesh, beam_width=1,
                                      max_words=6,
                                      compute_dtype=jnp.float32)
    assert tok.shape == (8, 8)


def test_vocab_tp_divisibility_guard():
    cfg = small_cfg(vocab_size=49)  # odd: not divisible by model axis 2
    mesh = make_mesh((4, 2))
    with pytest.raises(ValueError, match="divisible by the 'model'"):
        ShardedTrainStep(cfg, make_optimizer(cfg), mesh)


_MULTIPROC_CHILD = """
import os, sys
pid, port = int(sys.argv[1]), sys.argv[2]
os.environ.pop("XLA_FLAGS", None)   # 1 CPU device per process
import jax
# the config flag wins over any JAX_PLATFORMS preset: these processes
# exercise the CPU collectives even on a machine with a GPU
jax.config.update("jax_platforms", "cpu")
from lrcn_jax.parallel.distributed import host_local_batch, initialize
initialize("127.0.0.1:" + port, 2, pid)   # before any backend use
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
assert jax.process_count() == 2, jax.process_count()
from lrcn_jax.parallel import make_mesh
mesh = make_mesh((2, 1))
local = np.full((3, 4), pid + 1.0, np.float32)   # this host's batch rows
batch = host_local_batch(mesh, {"x": local})
assert batch["x"].shape == (6, 4)                 # global shape
total = jax.jit(jnp.sum,
                out_shardings=NamedSharding(mesh, P()))(batch["x"])
print("TOTAL", float(total), flush=True)
"""


def test_host_local_batch_two_processes(tmp_path):
    """Real multi-process path: 2 CPU processes join one coordination
    service and assemble a global batch via
    ``make_array_from_process_local_data`` (distributed.py).

    Rows from process 0 are 1.0 and from process 1 are 2.0; the global
    jitted sum must see BOTH hosts' data: 3*4*1 + 3*4*2 = 36.
    """
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _MULTIPROC_CHILD, str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)
        assert "TOTAL 36.0" in out, (out, err)


_TRAIN_CHILD = """
import os, sys
pid, port = int(sys.argv[1]), sys.argv[2]
os.environ.pop("XLA_FLAGS", None)   # 1 CPU device per process
import jax
jax.config.update("jax_platforms", "cpu")
from lrcn_jax.parallel.distributed import host_local_batch, initialize
initialize("127.0.0.1:" + port, 2, pid)   # before any backend use
import numpy as np
from lrcn_jax.config import LRCNConfig
from lrcn_jax.models import lrcn
from lrcn_jax.parallel import ShardedTrainStep, make_mesh
from lrcn_jax.train.trainer import make_optimizer
cfg = LRCNConfig(hidden=(32, 32), embed=24, cnn_feature_dim=64,
                 vocab_size=48, batch_size=8, dropout=0.0,
                 compute_dtype="float32", seed=7)
mesh = make_mesh((2, 1))           # 2 processes x 1 device
step = ShardedTrainStep(cfg, make_optimizer(cfg), mesh)
params = step.shard_params(lrcn.init_params(jax.random.PRNGKey(0), cfg))
opt_state = step.init_opt(params)
rng = np.random.default_rng(3)
tokens = rng.integers(3, cfg.vocab_size, (8, 7)).astype(np.int32)
lengths = rng.integers(3, 8, (8,)).astype(np.int32)
feats = rng.standard_normal((8, cfg.cnn_feature_dim)).astype(np.float32)
lo, hi = pid * 4, pid * 4 + 4      # this host's half of the batch
batch = host_local_batch(mesh, {"tokens": tokens[lo:hi],
                                "lengths": lengths[lo:hi],
                                "feats": feats[lo:hi]})
loss = None
for i in range(3):
    params, opt_state, loss = step(params, opt_state, batch["tokens"],
                                   batch["lengths"], batch["feats"],
                                   jax.random.PRNGKey(100 + i))
print("LOSS %.6f" % float(loss), flush=True)
"""


def test_two_process_train_step_matches_single_process():
    """A REAL psum-carrying train step across two OS processes.

    Two CPU processes (1 device each) join one coordination service and
    run three sharded train steps, each holding only its half of the
    batch; the gradient all-reduce crosses the process boundary.  The
    loss after step 3 must equal the same schedule run single-process
    on an in-process 2-device mesh (the dryrun can't cover this — it
    runs all mesh devices inside one process)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _TRAIN_CHILD, str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    losses = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)
        line = [ln for ln in out.splitlines() if ln.startswith("LOSS ")]
        assert line, (out, err)
        losses.append(float(line[0].split()[1]))
    assert losses[0] == losses[1]   # replicated loss, both hosts agree

    # identical schedule on an in-process 2-device mesh
    cfg = small_cfg()
    mesh = make_mesh((2, 1))
    step = ShardedTrainStep(cfg, make_optimizer(cfg), mesh)
    params = step.shard_params(lrcn.init_params(jax.random.PRNGKey(0),
                                                cfg))
    opt_state = step.init_opt(params)
    rng = np.random.default_rng(3)
    tokens = rng.integers(3, cfg.vocab_size, (8, 7)).astype(np.int32)
    lengths = rng.integers(3, 8, (8,)).astype(np.int32)
    feats = rng.standard_normal((8, cfg.cnn_feature_dim)).astype(
        np.float32)
    batch = step.shard_batch(tokens, lengths, feats)
    loss = None
    for i in range(3):
        params, opt_state, loss = step(params, opt_state, *batch,
                                       jax.random.PRNGKey(100 + i))
    np.testing.assert_allclose(losses[0], float(loss), rtol=2e-5)


def test_initialize_single_worker_markers_stay_single_process(monkeypatch):
    """Single-node env markers (SLURM_JOB_NUM_NODES=1,
    OMPI_COMM_WORLD_SIZE=1) must NOT trigger cluster initialization;
    a count above one, or a coordinator address, must."""
    from lrcn_jax.parallel.distributed import _cluster_environment

    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "1")
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert not _cluster_environment()
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "2")
    assert _cluster_environment()
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    assert _cluster_environment()
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    assert _cluster_environment()


def test_gather_to_host_in_process_shardings():
    """gather_to_host returns exact values for sharded, replicated, and
    plain-numpy leaves (in-process every jax.Array is fully addressable;
    the cross-process branch is covered by the 2-process checkpoint
    test)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lrcn_jax.parallel.distributed import gather_to_host

    mesh = make_mesh((8, 1))
    rng = np.random.default_rng(0)
    sharded_v = rng.standard_normal((16, 4)).astype(np.float32)
    repl_v = rng.standard_normal((3, 5)).astype(np.float32)
    tree = {
        "sharded": jax.device_put(sharded_v,
                                  NamedSharding(mesh, P("data"))),
        "replicated": jax.device_put(repl_v, NamedSharding(mesh, P())),
        "plain": np.arange(6.0),
    }
    out = gather_to_host(tree)
    for leaf in jax.tree.leaves(out):
        assert isinstance(leaf, np.ndarray)
    np.testing.assert_array_equal(out["sharded"], sharded_v)
    np.testing.assert_array_equal(out["replicated"], repl_v)
    np.testing.assert_array_equal(out["plain"], np.arange(6.0))


_CKPT_CHILD = """
import os, sys
pid, port, ckpt = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ.pop("XLA_FLAGS", None)   # 1 CPU device per process
import jax
jax.config.update("jax_platforms", "cpu")
from lrcn_jax.parallel.distributed import initialize
initialize("127.0.0.1:" + port, 2, pid)   # before any backend use
import numpy as np
from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.models import lrcn
from lrcn_jax.parallel import ShardedTrainStep, make_mesh
from lrcn_jax.train.checkpoint import load_checkpoint, save_checkpoint
from lrcn_jax.train.trainer import make_optimizer
cfg = LRCNConfig(hidden=(32, 32), embed=24, cnn_feature_dim=64,
                 vocab_size=48, batch_size=8, dropout=0.0,
                 compute_dtype="float32", seed=7)
host_params = jax.tree.map(
    np.asarray, lrcn.init_params(jax.random.PRNGKey(0), cfg))
mesh = make_mesh((1, 2))   # vocab-TP: the 'model' axis SPANS processes
step = ShardedTrainStep(cfg, make_optimizer(cfg), mesh)
params = step.shard_params(lrcn.init_params(jax.random.PRNGKey(0), cfg))
opt_state = step.init_opt(params)
# the premise of the test: these leaves are NOT visible to one process
assert not params["embedding"].is_fully_addressable
assert not params["w_out"].is_fully_addressable
save_checkpoint(ckpt, params, vocab=Vocab([f"w{i}" for i in range(45)]),
                cfg=cfg, opt_state=opt_state, epoch=3)
# the barrier guarantees BOTH processes see the finished snapshot
loaded = load_checkpoint(ckpt)
got = jax.tree.leaves(loaded["params"])
want = jax.tree.leaves(host_params)
ok = (len(got) == len(want)
      and all(np.allclose(a, b) for a, b in zip(got, want))
      and loaded["epoch"] == 3
      and len(loaded["opt_leaves"]) == len(jax.tree.leaves(opt_state)))
print("CKPT_OK" if ok else "CKPT_MISMATCH", flush=True)
"""


def test_two_process_checkpoint_single_writer(tmp_path):
    """Checkpointing from a REAL 2-process run with params sharded ACROSS
    the processes (vocab-TP over a 2-process 'model' axis): every process
    calls save_checkpoint, the non-addressable embedding/w_out leaves are
    all-gathered collectively, only process 0 writes, and after the
    barrier BOTH processes load the snapshot and see the full unsharded
    values."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])

    ckpt = str(tmp_path / "ckpt")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CKPT_CHILD, str(pid), port, ckpt],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)
        assert "CKPT_OK" in out, (out, err)
    assert os.path.exists(os.path.join(ckpt, "config.json"))
    assert not os.path.exists(ckpt + ".tmp")


_FIT_CHILD = """
import os, sys
pid, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ.pop("XLA_FLAGS", None)   # 1 CPU device per process
import jax
jax.config.update("jax_platforms", "cpu")
from lrcn_jax import cli
rc = cli.main([
    "train", "--datafiles", os.path.join(tmp, "captions_train.json"),
    os.path.join(tmp, "captions_val.json"),
    "--features", os.path.join(tmp, "feats"),
    "--val-features", os.path.join(tmp, "feats"),
    "--savefile", os.path.join(tmp, "ckpt_2proc"),
    "--bestfile", os.path.join(tmp, "best_2proc"),
    "--metrics", os.path.join(tmp, "metrics_%d.jsonl" % pid),
    "--epochs", "2", "--batchsize", "8", "--mesh", "1", "2",
    "--hidden", "32", "32", "--embed", "24", "--seed", "3",
    "--dropout", "0.0", "--compute-dtype", "float32",
    "--coordinator", "127.0.0.1:" + port,
    "--num-processes", "2", "--process-id", str(pid)])
print("FIT_RC=%d" % rc, flush=True)
"""


def test_two_process_cli_fit_matches_single_process(tmp_path):
    """End-to-end multi-host `lrcn train`: two OS processes (1 CPU device
    each) join one coordination service via the CLI's --coordinator
    flags, train 2 epochs on a vocab-TP mesh whose 'model' axis SPANS the
    processes, and produce (a) a checkpoint identical to the in-process
    2-device run of the same command and (b) exactly one metrics file —
    process 1's writer is gated off."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from lrcn_jax import cli
    from lrcn_jax.data.feature_store import FeatureStore, l1_normalize
    from lrcn_jax.train.checkpoint import load_checkpoint

    # tiny COCO-style corpus: 48 images x 5 captions, 12 caption classes,
    # vocabulary size 20 (divisible by the model axis)
    words = ["a", "man", "rides", "his", "bike", "dog", "runs", "on",
             "grass", "two", "children", "play", "in", "the", "park",
             "near", "water"]
    rng = np.random.default_rng(17)
    caps = [" ".join(rng.choice(words, 7)) + " ." for _ in range(12)]
    anns = [{"image_id": 5000 + i, "caption": caps[i % 12]}
            for i in range(48) for _ in range(5)]
    with open(tmp_path / "captions_train.json", "w") as f:
        json.dump({"annotations": anns}, f)
    # val split reuses the first 12 images (same word set -> same vocab);
    # exercises the cross-process average_loss + --bestfile path
    val_anns = [{"image_id": 5000 + i, "caption": caps[(i + 3) % 12]}
                for i in range(12) for _ in range(5)]
    with open(tmp_path / "captions_val.json", "w") as f:
        json.dump({"annotations": val_anns}, f)
    feats = rng.standard_normal((48, 16)).astype(np.float32)
    FeatureStore.from_dict(
        {5000 + i: l1_normalize(feats[i:i + 1])[0] for i in range(48)},
        normalized=True).save(str(tmp_path / "feats"))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _FIT_CHILD, str(pid), port,
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)
        assert "FIT_RC=0" in out, (out, err)

    # single writer: only process 0's metrics file exists
    assert os.path.exists(tmp_path / "metrics_0.jsonl")
    assert not os.path.exists(tmp_path / "metrics_1.jsonl")
    epochs = [json.loads(ln) for ln in open(tmp_path / "metrics_0.jsonl")
              if json.loads(ln).get("event") == "epoch"]
    assert [e["epoch"] for e in epochs] == [1, 2]
    # val loss computed collectively (sharded eval batches, replicated
    # sums) and logged by the single writer
    assert all("val_loss" in e for e in epochs), epochs

    # the same command in-process on a 2-device (1,2) mesh
    assert cli.main([
        "train", "--datafiles", str(tmp_path / "captions_train.json"),
        str(tmp_path / "captions_val.json"),
        "--features", str(tmp_path / "feats"),
        "--val-features", str(tmp_path / "feats"),
        "--savefile", str(tmp_path / "ckpt_1proc"),
        "--bestfile", str(tmp_path / "best_1proc"),
        "--metrics", str(tmp_path / "metrics_1proc.jsonl"),
        "--epochs", "2", "--batchsize", "8", "--mesh", "1", "2",
        "--hidden", "32", "32", "--embed", "24", "--seed", "3",
        "--dropout", "0.0", "--compute-dtype", "float32"]) == 0
    epochs1 = [json.loads(ln)
               for ln in open(tmp_path / "metrics_1proc.jsonl")
               if json.loads(ln).get("event") == "epoch"]
    for e2, e1 in zip(epochs, epochs1):
        assert abs(e2["val_loss"] - e1["val_loss"]) < 1e-3, (epochs,
                                                             epochs1)
    # the improving-val bestfile checkpoint exists and matches too
    best2 = load_checkpoint(str(tmp_path / "best_2proc"))
    best1 = load_checkpoint(str(tmp_path / "best_1proc"))
    for a, b in zip(jax.tree.leaves(best2["params"]),
                    jax.tree.leaves(best1["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    two = load_checkpoint(str(tmp_path / "ckpt_2proc"))
    one = load_checkpoint(str(tmp_path / "ckpt_1proc"))
    assert two["epoch"] == one["epoch"] == 2
    leaves2 = jax.tree.leaves(two["params"])
    leaves1 = jax.tree.leaves(one["params"])
    assert len(leaves2) == len(leaves1)
    for a, b in zip(leaves2, leaves1):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


_SEED_CHILD = """
import os, sys
pid, port = int(sys.argv[1]), sys.argv[2]
os.environ.pop("XLA_FLAGS", None)
import jax
jax.config.update("jax_platforms", "cpu")
from lrcn_jax.parallel.distributed import initialize, shared_seed
initialize("127.0.0.1:" + port, 2, pid)
print("SEED=%d" % shared_seed(None), flush=True)
print("EXPLICIT=%d" % shared_seed(41), flush=True)
"""


def test_two_process_shared_seed_agrees(tmp_path):
    """Unseeded multi-process runs broadcast process 0's shuffle entropy:
    both processes report the SAME seed (and explicit seeds pass
    through), so batch streams can never silently diverge."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _SEED_CHILD, str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    seeds, explicit = [], []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)
        seeds += [ln for ln in out.splitlines() if ln.startswith("SEED=")]
        explicit += [ln for ln in out.splitlines()
                     if ln.startswith("EXPLICIT=")]
    assert len(seeds) == 2 and seeds[0] == seeds[1], seeds
    assert explicit == ["EXPLICIT=41", "EXPLICIT=41"]


_JOINT_FIT_CHILD = """
import functools, os, sys
pid, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ.pop("XLA_FLAGS", None)   # 1 CPU device per process
import jax
jax.config.update("jax_platforms", "cpu")
from lrcn_jax.models import vgg as vgg_mod
_orig = vgg_mod.init_vgg_params
vgg_mod.init_vgg_params = functools.partial(
    _orig, width_multiplier=0.05, fc_dim=24)
from lrcn_jax import cli
rc = cli.main([
    "train", "--joint", "--images", os.path.join(tmp, "imgs"),
    "--datafiles", os.path.join(tmp, "captions_train.json"),
    "--savefile", os.path.join(tmp, "joint_2proc"),
    "--metrics", os.path.join(tmp, "jmetrics_%d.jsonl" % pid),
    "--epochs", "1", "--batchsize", "4", "--mesh", "2", "1",
    "--hidden", "16", "16", "--embed", "12", "--seed", "3",
    "--dropout", "0.0", "--compute-dtype", "float32",
    "--coordinator", "127.0.0.1:" + port,
    "--num-processes", "2", "--process-id", str(pid)])
print("FIT_RC=%d" % rc, flush=True)
"""


def test_two_process_cli_joint_fit_matches_single_process(tmp_path,
                                                          monkeypatch):
    """End-to-end multi-host `lrcn train --joint`: two OS processes (1 CPU
    device each) fine-tune CNN+decoder on a data-parallel mesh whose
    'data' axis SPANS the processes — each host decodes the batch's
    images and the sharded device_put extracts its rows (models/joint.py
    host->sharded staging) — and produce a checkpoint identical to the
    in-process 2-device run, with only process 0 writing metrics."""
    import functools
    import json
    import os
    import socket
    import subprocess
    import sys

    from PIL import Image

    from lrcn_jax import cli
    from lrcn_jax.models import vgg as vgg_mod
    from lrcn_jax.train.checkpoint import load_checkpoint

    rng = np.random.default_rng(6)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    ids = [41000 + i for i in range(8)]
    for iid in ids:
        Image.fromarray(
            rng.integers(0, 255, (230, 260, 3)).astype(np.uint8)
        ).save(str(img_dir / f"COCO_train2014_{iid:012d}.jpg"))
    words = ["a", "man", "rides", "his", "bike", "dog", "runs", "on"]
    anns = [{"image_id": iid, "caption": " ".join(rng.choice(words, 5))}
            for iid in ids for _ in range(5)]
    with open(tmp_path / "captions_train.json", "w") as f:
        json.dump({"annotations": anns}, f)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _JOINT_FIT_CHILD, str(pid), port,
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)
        assert "FIT_RC=0" in out, (out, err)

    # single writer: only process 0's metrics file exists
    assert os.path.exists(tmp_path / "jmetrics_0.jsonl")
    assert not os.path.exists(tmp_path / "jmetrics_1.jsonl")

    # the same command in-process on a 2-device (2,1) mesh
    monkeypatch.setattr(
        vgg_mod, "init_vgg_params",
        functools.partial(vgg_mod.init_vgg_params,
                          width_multiplier=0.05, fc_dim=24))
    assert cli.main([
        "train", "--joint", "--images", str(img_dir),
        "--datafiles", str(tmp_path / "captions_train.json"),
        "--savefile", str(tmp_path / "joint_1proc"),
        "--epochs", "1", "--batchsize", "4", "--mesh", "2", "1",
        "--hidden", "16", "16", "--embed", "12", "--seed", "3",
        "--dropout", "0.0", "--compute-dtype", "float32"]) == 0

    two = load_checkpoint(str(tmp_path / "joint_2proc"))
    one = load_checkpoint(str(tmp_path / "joint_1proc"))
    assert two["epoch"] == one["epoch"] == 1
    leaves2 = jax.tree.leaves(two["params"])
    leaves1 = jax.tree.leaves(one["params"])
    assert len(leaves2) == len(leaves1)
    for a, b in zip(leaves2, leaves1):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
