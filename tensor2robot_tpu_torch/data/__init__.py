"""Input generators: model specs → batched host data streams."""

from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Mode,
)
from tensor2robot_tpu_torch.data.episode_input_generator import (
    SEQUENCE_LENGTH_KEY,
    EpisodeInputGenerator,
)
from tensor2robot_tpu_torch.data.prefetch import (
    DevicePrefetcher,
    TimedIterator,
    prefetch_buffer_size,
    stack_batches,
)
from tensor2robot_tpu_torch.data.random_input_generator import (
    RandomInputGenerator,
)

__all__ = ["AbstractInputGenerator", "DevicePrefetcher",
           "EpisodeInputGenerator", "Mode", "RandomInputGenerator",
           "SEQUENCE_LENGTH_KEY", "TimedIterator", "prefetch_buffer_size",
           "stack_batches"]
