"""Knet/JLD checkpoint import: bring a reference-trained model over.

The reference checkpoints with ``save(file, "model", model, "vocab",
vocab)`` (lrcn.jl:185,230): ``model`` is the flat ``Array{Any}`` parameter
list (KnetArrays round-tripped to plain ``Array{Float32,2}`` by the
KnetJLD shim, lrcn.jl:776-781) and ``vocab`` is the ``Dict{String,Int}``
word->id table.  A user migrating from the reference should not have to
retrain — ``lrcn import-jld model.jld --savefile ckpt`` converts such a
file into a native checkpoint directory that every subcommand
(``generate``, ``caption``, ``serve``, ``export``) loads.

JLD is HDF5 plus Julia type metadata (the JLD.jl v1 format the
reference's Julia-0.5-era stack wrote):

- ``Array{Float32,N}`` -> a plain HDF5 dataset with the dimensions
  REVERSED (Julia is column-major; HDF5 row-major), so the Julia array
  is ``np.transpose`` of what h5py reads;
- ``Array{Any}`` -> a dataset of HDF5 object references, one per element;
- ``Dict{K,V}`` -> JLD wraps it in ``JLD.AssociativeWrapper`` and writes
  a compound dataset whose ``keys``/``vals`` fields are references to the
  key and value vectors;
- ``Vector{String}`` -> a variable-length string dataset.

The reader below follows references and compounds generically, so it
tolerates layout variations (group-style composites, plain datasets) and
fails with a precise message when a file doesn't hold what a reference
checkpoint must.  The writer reproduces the full JLD.jl 0.1.x on-disk
format so JLD.jl/FileIO can recognize and load the export:

- a 512-byte HDF5 userblock whose first bytes are the magic string
  ``Julia data file (HDF5), version: 0.1.1`` (JLD.jl checks this before
  opening, and FileIO's format sniffing dispatches on it);
- ``/_refs`` holding the referenced objects under sequential decimal
  names (``1``, ``2``, ...) the way JLD.jl's write_ref counter names
  them;
- ``/_types`` holding COMMITTED (named) compound datatypes, each
  carrying a ``julia type`` string attribute with the full typename —
  JLD.jl resolves a compound dataset's Julia type from the committed
  datatype's attribute, not from the dataset;
- a ``julia type`` string attribute (``Array{Any,1}``) on
  reference-array datasets (bits-type arrays are self-describing and
  carry no attribute);
- ``/_creator`` bookkeeping datasets (JULIA_MAJOR/MINOR/PATCH,
  WORD_SIZE, ENDIAN_BOM).

Caveat: this sandbox has no Julia, so the format is implemented from
JLD.jl's published conventions and validated by our own reader plus raw
HDF5/byte-level tests, not by a live ``jldopen`` — see
docs/MIGRATION.md for the first-contact checklist if JLD.jl still
rejects a file.

Parameter-list layout (reference ``initweights``, lrcn.jl:489-510) and
the mapping to :mod:`lrcn_jax.models.lrcn` params — gate order
[forget, ingate, outgate, change] and the ``(X+H, 4H)`` packing match
the reference exactly (models/lrcn.py docstring), so no gate permutation
is needed:

    w[1] (E+H1, 4H1)   -> params["lstm1"]["w"]
    w[2] (1, 4H1)      -> params["lstm1"]["b"]   (flattened)
    w[3] (2F+H2, 4H2)  -> params["lstm2"]["w"]
    w[4] (1, 4H2)      -> params["lstm2"]["b"]
    w[5] (H1, F)       -> params["w_factor"]     [ref w[end-4]]
    w[6] (C, F)        -> params["w_cnn"]        [ref w[end-3]]
    w[7] (V, E)        -> params["embedding"]    [ref w[end-2]]
    w[8] (H2, V)       -> params["w_out"]        [ref w[end-1]]
    w[9] (1, V)        -> params["b_out"]        [ref w[end]]

Vocabulary ids: the reference reserves ``~~``/``` `` ```/``##`` as ids
1/2/3 (tokenizer.jl:157-159); ours are the same tokens at 0/1/2
(core/vocab.py), so the Julia 1-based -> Python 0-based shift makes the
id spaces line up row-for-row with the embedding matrix — no row
permutation either.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import BOS_TOKEN, EOS_TOKEN, UNK_TOKEN, Vocab

_RESERVED = (EOS_TOKEN, BOS_TOKEN, UNK_TOKEN)


def _decode_str(s: Any) -> str:
    if isinstance(s, bytes):
        return s.decode("utf-8", errors="replace")
    return str(s)


def _read_value(f, obj) -> Any:
    """Read one JLD value: follow references, reverse array dims."""
    import h5py

    if isinstance(obj, h5py.Reference):
        if not obj:                      # null ref = Julia #undef
            return None
        return _read_value(f, f[obj])
    if isinstance(obj, h5py.Group):
        return {k: _read_value(f, v) for k, v in obj.items()}
    if isinstance(obj, h5py.Datatype):   # committed type (JLD /_types)
        return None

    dt = obj.dtype
    data = obj[()]
    if isinstance(data, h5py.Empty):     # H5S_NULL: Julia zero-size array
        dims = obj.attrs.get("dims")     # JLD stores Julia-order dims here
        shape = tuple(int(d) for d in np.asarray(dims).reshape(-1)) \
            if dims is not None else (0,)
        return np.zeros(shape, dtype=dt if not dt.names else np.float32)

    if dt.names:                         # compound (JLD composite type)
        rec = data if data.shape == () else data.reshape(-1)[0]
        return {name: _read_value(f, rec[name]) for name in dt.names}
    if h5py.check_ref_dtype(dt):         # Array{Any} / boxed values
        flat = np.asarray(data).reshape(-1)
        return [_read_value(f, r) for r in flat]
    if h5py.check_string_dtype(dt):      # Vector{String} / String
        if np.isscalar(data) or getattr(data, "shape", None) == ():
            return _decode_str(data)
        return [_decode_str(s) for s in np.asarray(data).reshape(-1)]
    arr = np.asarray(data)
    if arr.ndim >= 2:
        # HDF5 stores Julia arrays with dims reversed (column-major ->
        # row-major); transpose back to the Julia orientation.
        arr = np.transpose(arr)
    return arr


def read_jld(path: str) -> dict[str, Any]:
    """Read a JLD file's top-level variables (JLD bookkeeping skipped)."""
    import h5py

    out: dict[str, Any] = {}
    with h5py.File(path, "r") as f:
        for name, obj in f.items():
            if name.startswith(("_", "#")):   # /_refs, /_types, #refs#
                continue
            out[name] = _read_value(f, obj)
    return out


def _describe_node(obj) -> str:
    import h5py

    if isinstance(obj, h5py.Group):
        return f"group with {len(obj)} members"
    if isinstance(obj, h5py.Datatype):
        return "committed datatype"
    dt = obj.dtype
    if dt.names:
        kind = f"compound({', '.join(dt.names)})"
    elif h5py.check_ref_dtype(dt):
        kind = "object references"
    elif h5py.check_string_dtype(dt):
        kind = "strings"
    else:
        kind = str(dt)
    jt = obj.attrs.get("julia type")
    tail = f" [julia type: {_decode_str(jt)}]" if jt is not None else ""
    return f"dataset {kind} shape={tuple(obj.shape or ())}{tail}"


def describe_jld(path: str) -> str:
    """One-line-per-entry dump of a JLD/HDF5 file's top-level structure
    — attached to every import error so first-contact failures are
    diagnosable from the message alone (docs/MIGRATION.md checklist)."""
    import h5py

    lines = []
    try:
        with h5py.File(path, "r") as f:
            ub = f.id.get_create_plist().get_userblock()
            magic = ""
            if ub:
                with open(path, "rb") as raw:
                    head = raw.read(64).split(b"\x00", 1)[0]
                magic = f" userblock[{ub}]={head.decode('latin1')!r}"
            lines.append(f"{path}: HDF5{magic}")
            for name in f:
                lines.append(f"  /{name}: {_describe_node(f[name])}")
            if not len(f):
                lines.append("  (no top-level entries)")
    except OSError as e:
        lines.append(f"{path}: not readable as HDF5 ({e})")
    return "\n".join(lines)


def _as_matrix(x: Any, what: str) -> np.ndarray:
    if not isinstance(x, np.ndarray):
        raise ValueError(f"JLD model entry {what} is not an array "
                         f"(got {type(x).__name__})")
    return np.asarray(x, np.float32)


def _as_bias(x: Any, what: str) -> np.ndarray:
    b = _as_matrix(x, what)
    if b.ndim == 2 and 1 in b.shape:
        b = b.reshape(-1)
    if b.ndim != 1:
        raise ValueError(f"JLD model entry {what} should be a bias "
                         f"(1, n) / (n,); got shape {b.shape}")
    return b


def knet_params_from_model(model: list) -> tuple[dict, LRCNConfig]:
    """Map the reference's flat 9-array param list to a native pytree.

    Returns ``(params, cfg)`` with ``cfg`` carrying the architecture the
    shapes imply (``vocab_size`` included).  Raises ``ValueError`` with
    the exact mismatch for anything that isn't a reference LRCN
    checkpoint (lrcn.jl:489-510 shapes).
    """
    if len(model) != 9:
        raise ValueError(
            f"a reference LRCN checkpoint has 9 parameter arrays "
            f"(initweights, lrcn.jl:489-510); this file has {len(model)}")

    w1 = _as_matrix(model[0], "w[1] (LSTM-1 weights)")
    b1 = _as_bias(model[1], "w[2] (LSTM-1 bias)")
    w2 = _as_matrix(model[2], "w[3] (LSTM-2 weights)")
    b2 = _as_bias(model[3], "w[4] (LSTM-2 bias)")
    w_factor = _as_matrix(model[4], "w[5] (h1 factor projection)")
    w_cnn = _as_matrix(model[5], "w[6] (CNN projection)")
    embedding = _as_matrix(model[6], "w[7] (embedding)")
    w_out = _as_matrix(model[7], "w[8] (output projection)")
    b_out = _as_bias(model[8], "w[9] (output bias)")

    if w1.shape[1] % 4 or w2.shape[1] % 4:
        raise ValueError("LSTM weight columns must be 4*hidden (packed "
                         f"gates); got {w1.shape} / {w2.shape}")
    h1 = w1.shape[1] // 4
    h2 = w2.shape[1] // 4
    e = w1.shape[0] - h1
    f2 = w2.shape[0] - h2                       # 2 * factor width
    if e <= 0 or f2 <= 0 or f2 % 2:
        raise ValueError(
            f"LSTM input widths don't factor: w[1] {w1.shape} implies "
            f"embed={e}, w[3] {w2.shape} implies concat width={f2} "
            "(must be positive / even)")
    f = f2 // 2
    if f != math.ceil(h2 / 2):
        raise ValueError(
            f"factor width {f} != ceil(hidden2/2) = {math.ceil(h2 / 2)} "
            "— not a reference LRCN layout (lrcn.jl:504-505)")
    v, c = embedding.shape[0], w_cnn.shape[0]

    checks = {
        "w[2] (LSTM-1 bias)": (b1.shape, (4 * h1,)),
        "w[4] (LSTM-2 bias)": (b2.shape, (4 * h2,)),
        "w[5] (h1 factor projection)": (w_factor.shape, (h1, f)),
        "w[6] (CNN projection)": (w_cnn.shape, (c, f)),
        "w[7] (embedding)": (embedding.shape, (v, e)),
        "w[8] (output projection)": (w_out.shape, (h2, v)),
        "w[9] (output bias)": (b_out.shape, (v,)),
    }
    for what, (got, want) in checks.items():
        if tuple(got) != tuple(want):
            raise ValueError(f"JLD model entry {what} has shape {got}, "
                             f"expected {want} from the other entries")

    params = {
        "lstm1": {"w": w1, "b": b1},
        "lstm2": {"w": w2, "b": b2},
        "w_factor": w_factor,
        "w_cnn": w_cnn,
        "embedding": embedding,
        "w_out": w_out,
        "b_out": b_out,
    }
    cfg = LRCNConfig(hidden=(h1, h2), embed=e, cnn_feature_dim=c,
                     vocab_size=v)
    return params, cfg


def vocab_from_jld(value: Any) -> Vocab:
    """Build a :class:`Vocab` from the JLD ``vocab`` value.

    Accepts the AssociativeWrapper shape ({'keys': [...], 'vals': [...]})
    or any mapping read from the file.  Validates the reference's
    reserved tokens at ids 1/2/3 (tokenizer.jl:157-159) and id
    contiguity, then shifts to our 0-based ids.
    """
    mapping: dict[str, int]
    if isinstance(value, dict) and {"keys", "vals"} <= set(value):
        keys, vals = value["keys"], value["vals"]
        keys = [_decode_str(k) for k in np.asarray(keys, object).reshape(-1)]
        vals = [int(x) for x in np.asarray(vals).reshape(-1)]
        if len(keys) != len(vals):
            raise ValueError(f"vocab keys/vals length mismatch: "
                             f"{len(keys)} vs {len(vals)}")
        mapping = dict(zip(keys, vals))
    elif isinstance(value, dict):
        mapping = {_decode_str(k): int(v) for k, v in value.items()}
    else:
        raise ValueError("the JLD 'vocab' entry is not a Dict "
                         f"(got {type(value).__name__})")

    n = len(mapping)
    by_id = [None] * n
    for word, idx in mapping.items():
        if not 1 <= idx <= n or by_id[idx - 1] is not None:
            raise ValueError(
                f"vocab ids are not a 1..{n} permutation (word {word!r} "
                f"has id {idx})")
        by_id[idx - 1] = word
    if tuple(by_id[:3]) != _RESERVED:
        raise ValueError(
            f"vocab ids 1/2/3 are {by_id[:3]}, expected the reference's "
            f"reserved eos/bos/unk tokens {list(_RESERVED)} "
            "(tokenizer.jl:157-159)")
    return Vocab(by_id[3:])


def julia_model_from_params(params: dict) -> list:
    """Native param pytree -> the reference's flat 9-array list.

    Julia orientation, biases as the reference's ``(1, n)`` row matrices
    (initweights, lrcn.jl:499-508).  Inverse of
    :func:`knet_params_from_model` — gate order and packing already
    match, so no permutation happens in either direction.
    """
    row = lambda b: np.asarray(b, np.float32).reshape(1, -1)
    mat = lambda a: np.asarray(a, np.float32)
    return [
        mat(params["lstm1"]["w"]), row(params["lstm1"]["b"]),
        mat(params["lstm2"]["w"]), row(params["lstm2"]["b"]),
        mat(params["w_factor"]), mat(params["w_cnn"]),
        mat(params["embedding"]), mat(params["w_out"]),
        row(params["b_out"]),
    ]


def julia_vocab_map(vocab: Vocab) -> dict[str, int]:
    """Word -> 1-based id, reserved eos/bos/unk landing at 1/2/3 —
    exactly the reference's reserved-slot protocol (tokenizer.jl:157-159)
    under the Julia 1-based <- Python 0-based shift."""
    return {w: i + 1 for i, w in enumerate(vocab.words)}


#: JLD.jl magic: first bytes of the 512-byte HDF5 userblock.  0.1.1 is
#: the format version the reference-era JLD.jl (Julia 0.5/0.6) wrote;
#: any 0.1.x parses identically in every JLD.jl release.
JLD_MAGIC = b"Julia data file (HDF5), version: 0.1.1"
_ASSOC_TYPENAME = "JLD.AssociativeWrapper{String,Int64,Dict{String,Int64}}"


def write_jld(path: str, model_julia: list,
              vocab_map: dict[str, int]) -> None:
    """Write ``model``/``vocab`` in the JLD.jl 0.1.x on-disk format the
    reference's checkpoints use (lrcn.jl:185) — see the module docstring
    for the format pieces (userblock magic, numbered ``/_refs``,
    committed ``/_types`` compound carrying the ``julia type`` attr,
    ``/_creator``).  Julia arrays land in HDF5 with dims REVERSED
    (column-major -> row-major); ``Array{Any}`` is a dataset of object
    references; the Dict is an ``AssociativeWrapper`` scalar compound
    whose keys/vals fields reference the key and value vectors.  Same
    caveat as the reader: implemented from JLD.jl's published format —
    no Julia in this sandbox to cross-check with ``jldopen`` itself."""
    import h5py

    str_t = h5py.string_dtype()
    with h5py.File(path, "w", userblock_size=512) as f:
        # /_creator bookkeeping, as JLD.jl records on file creation
        # (values mirror the reference's Julia-0.5 era; informational).
        creator = f.create_group("_creator")
        for name, val in (("JULIA_MAJOR", np.int64(0)),
                          ("JULIA_MINOR", np.int64(5)),
                          ("JULIA_PATCH", np.int64(0)),
                          ("WORD_SIZE", np.int64(64)),
                          ("ENDIAN_BOM", np.uint32(0x04030201))):
            creator.create_dataset(name, data=val)

        # /_refs: referenced objects under sequential decimal names —
        # JLD.jl's write_ref counter naming, in the reference's
        # save("model", ..., "vocab", ...) write order: the 9 model
        # arrays (1-9), then the vocab keys (10) and vals (11).
        refs = f.create_group("_refs")
        mrefs = []
        for i, a in enumerate(model_julia):
            d = refs.create_dataset(
                str(i + 1), data=np.ascontiguousarray(np.transpose(a)))
            mrefs.append(d.ref)
        dm = f.create_dataset("model",
                              data=np.array(mrefs, dtype=h5py.ref_dtype))
        # reference-array datasets carry their Julia type as a string
        # attribute (bits-type arrays are self-describing and carry none)
        dm.attrs.create("julia type", "Array{Any,1}", dtype=str_t)

        words = list(vocab_map)
        kd = refs.create_dataset(
            str(len(model_julia) + 1),
            data=np.array(words, dtype=str_t))
        vd = refs.create_dataset(
            str(len(model_julia) + 2),
            data=np.array([vocab_map[w] for w in words], np.int64))

        # /_types: the committed compound datatype for the Dict wrapper.
        # JLD.jl resolves a compound's Julia type by reading the
        # `julia type` attribute off the COMMITTED datatype, so the
        # vocab dataset must be created with this named type.
        comp = np.dtype([("keys", h5py.ref_dtype),
                         ("vals", h5py.ref_dtype)])
        f["_types/00000001"] = comp
        tdef = f["_types/00000001"]
        tdef.attrs.create("julia type", _ASSOC_TYPENAME, dtype=str_t)
        f.create_dataset("vocab",
                         data=np.array((kd.ref, vd.ref), dtype=comp),
                         dtype=tdef)

    # The magic lives in the userblock, ahead of the HDF5 superblock —
    # JLD.jl checks it in jldopen and FileIO sniffs it to pick the JLD
    # loader.  h5py can only reserve the block; the bytes go in raw.
    with open(path, "r+b") as raw:
        raw.write(JLD_MAGIC.ljust(512, b"\x00"))


def export_knet_checkpoint(ckpt_dir: str, jld_path: str) -> dict[str, Any]:
    """Convert a native checkpoint directory into a reference-style JLD
    file (the reverse of :func:`import_knet_checkpoint`) so a model
    trained here can be taken back to the reference stack.

    Returns {'params', 'vocab', 'cfg'} (what was exported).  The pair is
    round-trip exact: ``import_knet_checkpoint(export(...))`` recovers
    bit-equal parameters and the identical vocab.
    """
    from lrcn_jax.train.checkpoint import load_checkpoint

    ckpt = load_checkpoint(ckpt_dir)
    params = ckpt["params"]
    if set(params) == {"cnn", "decoder"}:
        # joint (--joint fine-tune) checkpoint: the reference's model.jld
        # is decoder-only (lrcn.jl:185), so the fine-tuned encoder stays
        # behind — the decoder alone is what the reference can load
        params = params["decoder"]
    write_jld(jld_path, julia_model_from_params(params),
              julia_vocab_map(ckpt["vocab"]))
    return {"params": params, "vocab": ckpt["vocab"], "cfg": ckpt["cfg"]}


def import_knet_checkpoint(jld_path: str, out_dir: str) -> dict[str, Any]:
    """Convert a reference JLD checkpoint into a native checkpoint dir.

    Returns {'params', 'vocab', 'cfg'} (what was written).  Every
    failure carries the file's top-level structure dump
    (:func:`describe_jld`) so a migration report is diagnosable from
    the error message alone.
    """
    from lrcn_jax.train.checkpoint import save_checkpoint

    def fail(msg: str):
        raise ValueError(f"{msg}\n\nfile structure:\n"
                         f"{describe_jld(jld_path)}")

    try:
        values = read_jld(jld_path)
        missing = [k for k in ("model", "vocab") if k not in values]
        if missing:
            raise ValueError(
                f"{jld_path} has no {'/'.join(missing)} entr"
                f"{'y' if len(missing) == 1 else 'ies'} — a reference "
                f"checkpoint stores both (lrcn.jl:185); found: "
                f"{sorted(values) or 'nothing'}")
        model = values["model"]
        if not isinstance(model, list):
            raise ValueError("the JLD 'model' entry is not an Array{Any} "
                             f"parameter list (got {type(model).__name__})")
        params, cfg = knet_params_from_model(model)
        vocab = vocab_from_jld(values["vocab"])
        if len(vocab) != cfg.vocab_size:
            raise ValueError(
                f"vocab has {len(vocab)} words but the embedding has "
                f"{cfg.vocab_size} rows — the file's model and vocab do "
                "not belong together")
    except (ValueError, OSError, KeyError) as e:
        fail(str(e))
    save_checkpoint(out_dir, params, vocab, cfg)
    return {"params": params, "vocab": vocab, "cfg": cfg}
