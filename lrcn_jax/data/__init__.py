from lrcn_jax.data.batcher import (  # noqa: F401
    Batch,
    bucket_batches,
    equal_length_batches,
    epoch_order,
)
from lrcn_jax.data.feature_store import FeatureStore  # noqa: F401
from lrcn_jax.data.pipeline import prefetch_to_device  # noqa: F401
