from lrcn_jax.decode.beam import beam_search, greedy_search  # noqa: F401
from lrcn_jax.decode.writer import (  # noqa: F401
    caption_to_line,
    generate_captions,
    write_candidate_files,
)
