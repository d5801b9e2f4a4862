"""Knet/JLD checkpoint import (lrcn_jax/data/jld.py).

The reference checkpoints ``save(file, "model", model, "vocab", vocab)``
(lrcn.jl:185,230).  No Julia exists in this sandbox, so these tests
build files to the JLD v1 on-disk conventions (HDF5 + reversed dims +
reference indirection + AssociativeWrapper dicts — see the module
docstring) and assert the importer recovers the exact parameters, the
vocab, and a checkpoint every decoder entry point can load.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import jax  # noqa: E402

from lrcn_jax.config import LRCNConfig  # noqa: E402
from lrcn_jax.core.vocab import Vocab  # noqa: E402
from lrcn_jax.data.jld import (  # noqa: E402
    export_knet_checkpoint,
    import_knet_checkpoint,
    knet_params_from_model,
    read_jld,
    vocab_from_jld,
    write_jld,
)
from lrcn_jax.models import lrcn as lrcn_model  # noqa: E402
from lrcn_jax.train.checkpoint import load_checkpoint  # noqa: E402


# the writer lives in the module now (export-jld uses it);
# params_to_julia_model is the module's julia_model_from_params
from lrcn_jax.data.jld import julia_model_from_params \
    as params_to_julia_model  # noqa: E402


@pytest.fixture(scope="module")
def small_model():
    words = [f"w{i}" for i in range(21)]
    vocab = Vocab(words)
    cfg = LRCNConfig(hidden=(10, 9), embed=8, cnn_feature_dim=12,
                     vocab_size=len(vocab))
    params = lrcn_model.init_params(jax.random.PRNGKey(7), cfg)
    params = jax.tree.map(np.asarray, params)
    return params, vocab, cfg


def julia_vocab_map(vocab, rng=None):
    """word -> 1-based id, in scrambled insertion order (the reference's
    Dict iteration order is hash-dependent; the importer must not care)."""
    items = [(w, i + 1) for i, w in enumerate(vocab.words)]
    if rng is not None:
        rng.shuffle(items)
    return dict(items)


def test_import_roundtrip_exact(tmp_path, small_model):
    params, vocab, cfg = small_model
    jld = str(tmp_path / "model.jld")
    write_jld(jld, params_to_julia_model(params),
              julia_vocab_map(vocab, np.random.default_rng(3)))

    out_dir = str(tmp_path / "ckpt")
    out = import_knet_checkpoint(jld, out_dir)
    assert out["vocab"].words == vocab.words
    assert tuple(out["cfg"].hidden) == tuple(cfg.hidden)
    assert out["cfg"].embed == cfg.embed
    assert out["cfg"].cnn_feature_dim == cfg.cnn_feature_dim
    assert out["cfg"].vocab_size == cfg.vocab_size

    loaded = load_checkpoint(out_dir)
    assert loaded["vocab"].words == vocab.words
    for path_key, leaf in [("lstm1", "w"), ("lstm1", "b"),
                           ("lstm2", "w"), ("lstm2", "b")]:
        np.testing.assert_array_equal(loaded["params"][path_key][leaf],
                                      params[path_key][leaf])
    for key in ("w_factor", "w_cnn", "embedding", "w_out", "b_out"):
        np.testing.assert_array_equal(loaded["params"][key], params[key])


def test_imported_checkpoint_decodes_identically(tmp_path, small_model):
    """The imported params drive the decoder bit-identically to the
    originals (i.e. the orientation/bias-flatten transforms are right
    end to end, not just shape-compatible)."""
    from lrcn_jax.decode.beam import beam_search

    params, vocab, _ = small_model
    jld = str(tmp_path / "model.jld")
    write_jld(jld, params_to_julia_model(params), julia_vocab_map(vocab))
    out_dir = str(tmp_path / "ckpt")
    import_knet_checkpoint(jld, out_dir)
    loaded = load_checkpoint(out_dir)

    feats = np.abs(np.random.default_rng(5).standard_normal(
        (4, 12)).astype(np.float32))
    feats /= feats.sum(axis=1, keepdims=True)
    want_t, want_s = beam_search(params, feats, beam_width=3, max_words=8,
                                 compute_dtype=np.float32)
    got_t, got_s = beam_search(loaded["params"], feats, beam_width=3,
                               max_words=8, compute_dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(got_t), np.asarray(want_t))
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(want_s))


def test_cli_import_jld(tmp_path, small_model, capsys):
    from lrcn_jax import cli

    params, vocab, _ = small_model
    jld = str(tmp_path / "model.jld")
    write_jld(jld, params_to_julia_model(params), julia_vocab_map(vocab))
    out_dir = str(tmp_path / "ckpt")
    assert cli.main(["import-jld", jld, "--savefile", out_dir]) == 0
    msg = capsys.readouterr().out
    assert "hidden=(10, 9)" in msg and "vocab=24" in msg
    assert load_checkpoint(out_dir)["cfg"].vocab_size == 24


def test_read_jld_skips_bookkeeping_and_reverses_dims(tmp_path):
    path = str(tmp_path / "x.jld")
    julia = np.arange(6, dtype=np.float32).reshape(2, 3)
    with h5py.File(path, "w") as f:
        f.create_group("_refs")
        f.create_dataset("a", data=np.ascontiguousarray(julia.T))
        f.create_dataset("s", data=np.array([b"hi", b"yo"],
                                            dtype=h5py.string_dtype()))
    vals = read_jld(path)
    assert set(vals) == {"a", "s"}
    np.testing.assert_array_equal(vals["a"], julia)
    assert vals["s"] == ["hi", "yo"]


def test_import_rejects_wrong_files(tmp_path, small_model):
    params, vocab, _ = small_model
    model = params_to_julia_model(params)

    # not a checkpoint at all
    empty = str(tmp_path / "empty.jld")
    with h5py.File(empty, "w"):
        pass
    with pytest.raises(ValueError, match="no model/vocab"):
        import_knet_checkpoint(empty, str(tmp_path / "o1"))

    # truncated param list
    with pytest.raises(ValueError, match="9 parameter arrays"):
        knet_params_from_model(model[:8])

    # an entry with an inconsistent shape
    bad = list(model)
    bad[4] = bad[4][:, :-1]                      # w_factor width off by 1
    with pytest.raises(ValueError, match="factor"):
        knet_params_from_model(bad)

    # vocab without the reference's reserved tokens at ids 1/2/3
    scrambled = {w: i + 1 for i, w in enumerate(vocab.words[::-1])}
    with pytest.raises(ValueError, match="reserved"):
        vocab_from_jld({"keys": list(scrambled),
                        "vals": list(scrambled.values())})

    # non-contiguous ids
    with pytest.raises(ValueError, match="permutation"):
        vocab_from_jld({"keys": ["~~", "``", "##", "a"],
                        "vals": [1, 2, 3, 9]})

    # model/vocab that don't belong together
    jld = str(tmp_path / "mismatch.jld")
    write_jld(jld, model, julia_vocab_map(Vocab(["only", "four", "w"])))
    with pytest.raises(ValueError, match="do not belong together"):
        import_knet_checkpoint(jld, str(tmp_path / "o2"))


def test_export_import_roundtrip_exact(tmp_path, small_model):
    """export-jld -> import-jld recovers bit-equal params and the
    identical vocab (the reverse-migration contract)."""
    from lrcn_jax.train.checkpoint import save_checkpoint

    params, vocab, cfg = small_model
    src = str(tmp_path / "native_ckpt")
    save_checkpoint(src, params, vocab, cfg)

    jld = str(tmp_path / "exported.jld")
    export_knet_checkpoint(src, jld)
    back = str(tmp_path / "reimported")
    import_knet_checkpoint(jld, back)
    loaded = load_checkpoint(back)
    assert loaded["vocab"].words == vocab.words
    flat_a = jax.tree.leaves(loaded["params"])
    flat_b = jax.tree.leaves(params)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_export_jld_joint_checkpoint_exports_decoder(tmp_path, small_model):
    """A --joint checkpoint (params = {cnn, decoder}) exports its
    decoder — the reference's model.jld is decoder-only (lrcn.jl:185)."""
    from lrcn_jax.train.checkpoint import save_checkpoint

    params, vocab, cfg = small_model
    joint = {"cnn": {"fc7": {"w": np.ones((3, 12), np.float32),
                             "b": np.zeros(12, np.float32)}},
             "decoder": params}
    src = str(tmp_path / "joint_ckpt")
    save_checkpoint(src, joint, vocab, cfg)

    jld = str(tmp_path / "exported.jld")
    out = export_knet_checkpoint(src, jld)
    assert set(out["params"]) == set(params)
    model = read_jld(jld)["model"]
    got, _ = knet_params_from_model(model)
    for key in ("w_factor", "w_cnn", "embedding", "w_out", "b_out"):
        np.testing.assert_array_equal(got[key], params[key])


def test_cli_export_jld(tmp_path, small_model, capsys):
    from lrcn_jax import cli
    from lrcn_jax.train.checkpoint import save_checkpoint

    params, vocab, cfg = small_model
    src = str(tmp_path / "ckpt")
    save_checkpoint(src, params, vocab, cfg)
    jld = str(tmp_path / "m.jld")
    assert cli.main(["export-jld", src, "--out", jld]) == 0
    assert "vocab=24" in capsys.readouterr().out
    # and the reference-convention layout reads back
    vals = read_jld(jld)
    assert isinstance(vals["model"], list) and len(vals["model"]) == 9


def test_written_jld_has_jldjl_format_pieces(tmp_path, small_model):
    """The export carries every piece JLD.jl's jldopen/FileIO dispatch
    needs: the 512-byte userblock magic, numbered /_refs, a COMMITTED
    /_types compound with the `julia type` attr (JLD.jl resolves
    compound types from the committed datatype), the `julia type` attr
    on the ref-array dataset, and /_creator bookkeeping."""
    from lrcn_jax.data.jld import JLD_MAGIC

    params, vocab, _ = small_model
    jld = str(tmp_path / "m.jld")
    write_jld(jld, params_to_julia_model(params), julia_vocab_map(vocab))

    with open(jld, "rb") as raw:
        head = raw.read(512)
    assert head.startswith(JLD_MAGIC)
    assert head == JLD_MAGIC.ljust(512, b"\x00")

    with h5py.File(jld, "r") as f:
        assert f.id.get_create_plist().get_userblock() == 512
        assert sorted(f["_refs"], key=int) == [str(i) for i in
                                               range(1, 12)]
        t = f["_types/00000001"]
        assert isinstance(t, h5py.Datatype)
        assert t.attrs["julia type"] == \
            "JLD.AssociativeWrapper{String,Int64,Dict{String,Int64}}"
        assert t.dtype.names == ("keys", "vals")
        dv = f["vocab"]
        assert dv.shape == ()                      # scalar compound
        assert h5py.h5d.DatasetID.get_type(dv.id).committed()
        assert f["model"].attrs["julia type"] == "Array{Any,1}"
        # bits-type arrays are self-describing: no julia type attr
        assert "julia type" not in f["_refs/1"].attrs
        assert {"JULIA_MAJOR", "WORD_SIZE", "ENDIAN_BOM"} <= \
            set(f["_creator"])


def test_import_legacy_convention_layout(tmp_path, small_model):
    """Files in the pre-round-5 layout (no userblock, named refs,
    per-element string attrs, dataset-level vocab attr, transient
    compound type) still import bit-exactly — the reader keys on
    structure, not bookkeeping."""
    params, vocab, _ = small_model
    model = params_to_julia_model(params)
    jld = str(tmp_path / "legacy.jld")
    with h5py.File(jld, "w") as f:
        refs = f.create_group("_refs")
        mrefs = []
        for i, a in enumerate(model):
            d = refs.create_dataset(
                f"m{i}", data=np.ascontiguousarray(np.transpose(a)))
            d.attrs["julia type"] = np.bytes_(f"Array{{Float32,{a.ndim}}}")
            mrefs.append(d.ref)
        f.create_dataset("model", data=np.array(mrefs,
                                                dtype=h5py.ref_dtype))
        vm = julia_vocab_map(vocab)
        kd = refs.create_dataset("vocab_keys", data=np.array(
            list(vm), dtype=h5py.string_dtype()))
        vd = refs.create_dataset("vocab_vals", data=np.array(
            list(vm.values()), np.int64))
        comp = np.dtype([("keys", h5py.ref_dtype),
                         ("vals", h5py.ref_dtype)])
        dv = f.create_dataset("vocab", data=np.array((kd.ref, vd.ref),
                                                     dtype=comp))
        dv.attrs["julia type"] = np.bytes_("JLD.AssociativeWrapper")
    out = import_knet_checkpoint(jld, str(tmp_path / "ckpt"))
    assert out["vocab"].words == vocab.words
    np.testing.assert_array_equal(out["params"]["w_out"], params["w_out"])


def test_import_tolerates_jldjl_bookkeeping(tmp_path, small_model):
    """Real JLD.jl files carry /_require, /_creator, committed /_types,
    1-element compound dataspaces, and H5S_NULL empty arrays — none of
    which may break the import."""
    params, vocab, _ = small_model
    jld = str(tmp_path / "full.jld")
    write_jld(jld, params_to_julia_model(params), julia_vocab_map(vocab))
    with h5py.File(jld, "a") as f:
        f.create_dataset("_require", data=np.array(
            ["SomeUserModule.jl"], dtype=h5py.string_dtype()))
        # an unrelated empty Julia array (H5S_NULL + dims attr)
        d = f.create_dataset("scratch", shape=None, dtype=np.float32,
                             data=h5py.Empty(np.float32))
        d.attrs["dims"] = np.array([0, 4], np.int64)
    vals = read_jld(jld)
    assert vals["scratch"].shape == (0, 4)
    out = import_knet_checkpoint(jld, str(tmp_path / "ckpt"))
    assert out["vocab"].words == vocab.words

    # 1-element (non-scalar) compound dataspace variant for the vocab
    jld2 = str(tmp_path / "vec.jld")
    write_jld(jld2, params_to_julia_model(params), julia_vocab_map(vocab))
    with h5py.File(jld2, "a") as f:
        comp = f["vocab"].dtype
        rec = f["vocab"][()]
        del f["vocab"]
        f.create_dataset("vocab", data=np.array([rec], dtype=comp))
    out2 = import_knet_checkpoint(jld2, str(tmp_path / "ckpt2"))
    assert out2["vocab"].words == vocab.words


def test_import_error_dumps_structure(tmp_path):
    """Every import failure ends with the file's top-level structure —
    the MIGRATION.md first-contact report is the error message."""
    jld = str(tmp_path / "odd.jld")
    with h5py.File(jld, "w") as f:
        f.create_dataset("weights", data=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError) as ei:
        import_knet_checkpoint(jld, str(tmp_path / "o"))
    msg = str(ei.value)
    assert "file structure:" in msg
    assert "/weights: dataset float32 shape=(3, 3)" in msg

    noth5 = str(tmp_path / "not.jld")
    with open(noth5, "w") as fh:
        fh.write("plain text")
    with pytest.raises(ValueError, match="not readable as HDF5"):
        import_knet_checkpoint(noth5, str(tmp_path / "o2"))


def test_vocab_from_plain_group_layout():
    """Group-style dict reads (a {word: id} mapping) also work — the
    reader is layout-tolerant."""
    v = vocab_from_jld({"~~": 1, "``": 2, "##": 3, b"cat": 4, "dog": 5})
    assert v.words == ["~~", "``", "##", "cat", "dog"]
