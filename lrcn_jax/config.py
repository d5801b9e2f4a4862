"""Configuration for the LRCN framework.

Mirrors the user-visible flag surface of the reference CLI
(reference: lrcn.jl:30-55, ArgParse table) as a typed dataclass, minus the
reference's dead/broken flags (``--gclip`` parsed but clipping commented out
at lrcn.jl:386-393; ``--lr`` parsed but Adam defaults used at lrcn.jl:399-405;
``:bestfile`` referenced at lrcn.jl:63 but never declared).  Here ``lr`` and
``gclip`` are real and wired into the optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# fc7 feature width of VGG-16 (reference: lrcn.jl:28 `const cnnout = 4096`).
CNN_FEATURE_DIM = 4096

# Captions longer than this are skipped during training/eval
# (reference: lrcn.jl:353-355, 437-439).
MAX_CAPTION_LEN = 28


@dataclasses.dataclass
class LRCNConfig:
    """Model + training + decoding configuration.

    Defaults match the reference defaults (lrcn.jl:32-55).
    """

    # --- model (reference: lrcn.jl:39-40, initweights lrcn.jl:489-510) ---
    hidden: Sequence[int] = (1000, 1000)   # LSTM layer widths
    embed: int = 1000                      # word-embedding width
    cnn_feature_dim: int = CNN_FEATURE_DIM
    vocab_size: int = 0                    # filled in after tokenization

    # --- training (reference: lrcn.jl:41-45, train! lrcn.jl:223-246) ---
    epochs: int = 10
    batch_size: int = 25
    lr: float = 1e-3          # Adam default, matching effective ref behavior
    gclip: float = 0.0        # 0 = off, matching effective ref behavior
    dropout: float = 0.4      # hard-coded at lrcn.jl:227
    seed: int = -1            # <=0 means unseeded (reference: lrcn.jl:60)
    max_caption_len: int = MAX_CAPTION_LEN

    # --- numerics (no reference equivalent) ---
    # Parameters are kept in float32; matmuls run in bfloat16 with f32
    # accumulation.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # --- decoding (reference: lrcn.jl:38,42,53) ---
    generate: int = 0          # max words to generate (0 = no generation)
    beam_width: int = 3
    capnumber: int = 1000      # number of captions for eval-set generation

    # --- data / io (reference: lrcn.jl:33-37,49-52) ---
    datafiles: Sequence[str] = ()
    loadfile: str | None = None
    savefile: str | None = None
    flickr: bool = False
    coco: bool = False
    image: str | None = None
    vgg_model: str | None = None   # MatConvNet .mat path (reference: lrcn.jl:34)

    # --- parallelism (new; the reference is single-GPU) ---
    mesh_shape: Sequence[int] = (1, 1)      # (data, model)
    mesh_axis_names: Sequence[str] = ("data", "model")

    def __post_init__(self):
        self.hidden = tuple(self.hidden)
        if len(self.hidden) != 2:
            raise ValueError(
                "the LRCN decoder is a factored 2-layer LSTM; got "
                f"hidden={self.hidden!r} (reference hard-codes 2 layers in "
                "its forward pass, lrcn.jl:540-551)"
            )

    @property
    def factor_dim(self) -> int:
        """Width of each half of the factored LSTM-2 input.

        Reference: lrcn.jl:504-505 — both the h1 projection and the CNN
        projection map to ``ceil(hidden2 / 2)``; their concat feeds LSTM-2.
        """
        return -(-self.hidden[1] // 2)
