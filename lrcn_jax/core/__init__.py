from lrcn_jax.core.vocab import Vocab, EOS_ID, BOS_ID, UNK_ID  # noqa: F401
from lrcn_jax.core.tokenizer import (  # noqa: F401
    Caption,
    tokenize,
    parse_flickr_tokens,
    flickr_split,
    parse_coco_json,
    build_vocab,
)
