"""Input generators: model specs → batched host data streams, and the
data plane that reads TFRecord files without TensorFlow."""

from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Mode,
)
from tensor2robot_tpu_torch.data.episode_input_generator import (
    EpisodeInputGenerator,
)
from tensor2robot_tpu_torch.data.plane import HostDataPlane
from tensor2robot_tpu_torch.data.prefetch import (
    DevicePrefetcher,
    TimedIterator,
    prefetch_buffer_size,
    stack_batches,
)
from tensor2robot_tpu_torch.data.random_input_generator import (
    RandomInputGenerator,
)
from tensor2robot_tpu_torch.data.shm_ring import ShmRing, WireLayout
from tensor2robot_tpu_torch.data.tfexample import SEQUENCE_LENGTH_KEY
from tensor2robot_tpu_torch.data.tfrecord_input_generator import (
    DefaultRecordInputGenerator,
    TFRecordEpisodeInputGenerator,
    TFRecordInputGenerator,
    write_episode_tfrecord,
    write_tfrecord,
)

__all__ = ["AbstractInputGenerator", "DefaultRecordInputGenerator",
           "DevicePrefetcher", "EpisodeInputGenerator", "HostDataPlane",
           "Mode", "RandomInputGenerator", "SEQUENCE_LENGTH_KEY", "ShmRing",
           "TFRecordEpisodeInputGenerator", "TFRecordInputGenerator",
           "TimedIterator", "WireLayout", "prefetch_buffer_size",
           "stack_batches", "write_episode_tfrecord", "write_tfrecord"]
