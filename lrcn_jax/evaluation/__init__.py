from lrcn_jax.evaluation.bleu import (  # noqa: F401
    BleuResult,
    multi_bleu,
    multi_bleu_files,
    load_reference_files,
)
from lrcn_jax.evaluation.references import (  # noqa: F401
    build_coco_references,
    build_flickr_references,
)
