"""Replay storage and augmentation."""

from alphazero_tpu_torch.data.augment import Symmetries
from alphazero_tpu_torch.data.replay import (ReplayBuffer, add_games, create,
                                             create_sharded, gather_sample,
                                             num_rows, num_rows_augmented,
                                             sample, sample_indices,
                                             shard_of, stack_shards,
                                             to_sharded)

__all__ = ["ReplayBuffer", "Symmetries", "add_games", "create",
           "create_sharded", "gather_sample", "num_rows",
           "num_rows_augmented", "sample", "sample_indices", "shard_of",
           "stack_shards", "to_sharded"]
