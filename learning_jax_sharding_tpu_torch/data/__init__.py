"""Input pipeline: token datasets and the batch loader.

Port of ``learning_jax_sharding_tpu/data`` (the tokenizers come with slice
D)."""

from learning_jax_sharding_tpu_torch.data.datasets import (  # noqa: F401
    CyclicLMDataset,
    MemmapTokenDataset,
    SyntheticLMDataset,
    write_token_file,
)
from learning_jax_sharding_tpu_torch.data.loader import (  # noqa: F401
    PrefetchIterator,
    ShardedBatchLoader,
)
