"""TFRecord-backed input generators (port of
`data/tfrecord_input_generator.py`), without TensorFlow.

The JAX generators run a tf.data pipeline; this is the same pipeline in
Python over the port's record reader (`data/tfrecord_io.py`) and parser
(`data/tfexample.py`):

  * the file list: each pattern's sorted glob, in pattern order (a
    pattern without `*` that matches nothing is kept, and fails when
    read); no file at all raises;
  * in TRAIN mode with `shuffle`, the file order is shuffled each pass;
  * files are interleaved as `tf.data.Dataset.interleave` does it, with
    cycle `min(num_parallel_reads, #files)` and a block of 1: a record
    from each open file in turn, an exhausted file's place refilled by
    the next file when the cycle returns to it;
  * TRAIN mode repeats (`repeat`) and shuffles records through a buffer
    of `shuffle_buffer_size` (`shuffle`), as `Dataset.shuffle` does;
    other modes read every file once, in interleave order;
  * batches of `batch_size` serialized records, the remainder dropped,
    each parsed in one call with the semantics of the JAX generator's
    graph parse (`tfexample.graph_parse_example` /
    `graph_parse_sequence_example`: PNG frames decoded to the spec's
    channels in one native unfilter call, "" time padding a zero frame).

The shuffles draw from a numpy generator made from `seed` (None: fresh
entropy), so they cannot repeat tf.data's own draws: TRAIN-mode streams
agree with the JAX generator as multisets per pass, EVAL-mode and
unshuffled streams record for record.

Feature and label keys share one record; a batch is parsed once over
their union and split after (a key in both specs lands in both).
`num_workers=0` parses in the iterating thread (under `train_eval`,
the `DevicePrefetcher`'s worker thread); `num_workers=N > 0` fans the
same pipeline over N spawned processes through `data.plane`, worker i
owning files[i::N] of the sorted list (N=1 gives the 0 stream exactly).
"""

from __future__ import annotations

import copy as copylib
import glob as globlib
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data import tfexample
from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Batch,
    Mode,
)
from tensor2robot_tpu_torch.data.shm_ring import WireLayout
from tensor2robot_tpu_torch.data.tfrecord_io import (
    TFRecordWriter,
    iterate_records,
)
from tensor2robot_tpu_torch.specs import packing
from tensor2robot_tpu_torch.specs.tensorspec import TensorSpecStruct


def _merge_specs(feature_spec, label_spec=None) -> TensorSpecStruct:
  """One flat struct over feature and label specs (one wire record holds
  all keys)."""
  merged = dict(packing.flatten_spec_structure(feature_spec).to_flat_dict())
  if label_spec is not None:
    merged.update(packing.flatten_spec_structure(label_spec).to_flat_dict())
  return TensorSpecStruct.from_flat_dict(merged)


def interleave(files: Sequence[str], cycle_length: int) -> Iterator[bytes]:
  """`tf.data.Dataset.interleave(TFRecordDataset, cycle_length)` with a
  block of 1:
  slots start empty; the cycle visits each slot in turn, opening the
  next file into an empty slot, taking one record from an open one, and
  moving on past a file that just ran out (its slot refills on the next
  visit)."""
  pending = iter(files)
  slots: List[Optional[Iterator[bytes]]] = [None] * max(1, cycle_length)
  open_count, inputs_left, index = 0, True, 0
  while inputs_left or open_count:
    current = slots[index]
    if current is not None:
      record = next(current, None)
      if record is not None:
        yield record
      else:
        slots[index] = None
        open_count -= 1
      index = (index + 1) % len(slots)
    elif inputs_left:
      path = next(pending, None)
      if path is None:
        inputs_left = False
      else:
        slots[index] = iterate_records(path)
        open_count += 1
    else:
      index = (index + 1) % len(slots)


def shuffle_buffer(stream: Iterable, buffer_size: int,
                   rng: np.random.Generator) -> Iterator:
  """`Dataset.shuffle(buffer_size)`: fill a buffer, then repeatedly emit
  a uniformly drawn element and put the next input in its place."""
  buffer: List = []
  it = iter(stream)
  for item in it:
    buffer.append(item)
    if len(buffer) >= buffer_size:
      break
  for item in it:
    index = int(rng.integers(len(buffer)))
    yield buffer[index]
    buffer[index] = item
  while buffer:
    index = int(rng.integers(len(buffer)))
    buffer[index], buffer[-1] = buffer[-1], buffer[index]
    yield buffer.pop()


class _WorkerSource:
  """Picklable worker body: one file shard → parsed flat-dict batches.

  Carries a copy of the generator (plain fields and picklable specs)
  with `num_workers` 0, so a worker never starts a plane of its own.
  """

  def __init__(self, generator: "TFRecordInputGenerator", mode: Mode,
               batch_size: int):
    worker_gen = copylib.copy(generator)
    worker_gen._num_workers = 0
    self._generator = worker_gen
    self._mode = Mode(mode)
    self._batch_size = int(batch_size)

  def __call__(self, worker_index: int,
               num_workers: int) -> Iterator[Dict[str, object]]:
    gen = self._generator
    # Worker i of N owns files[i::N] of the sorted list; N=1 is the
    # whole list in order (num_workers 0 and 1 give one stream).
    gen._files_override = gen._file_list()[worker_index::num_workers]
    if not gen._files_override:
      return  # more workers than files: this worker has no shard
    merged_struct, _, _ = gen._merged_spec()
    parse_fn = gen._parse_fn(merged_struct)
    yield from gen._batched_dataset(self._mode, self._batch_size, parse_fn)


class _PlaneStream:
  """Plane batches → (features, labels), with the release protocol.

  `release_after_transfer` / `release_consumed` are what the trainer's
  `DevicePrefetcher` reads: when batches are ring views (the plane does
  not copy), it copies each batch (into pinned memory on the card) and
  then calls `release_consumed()`, so the slot recycles only once the
  consumer owns the bytes.
  """

  def __init__(self, plane, split_fn):
    self._plane = plane
    self._split = split_fn

  @property
  def release_after_transfer(self) -> bool:
    return not self._plane.copies_batches

  def release_consumed(self) -> None:
    self._plane.release()

  def require_copies(self) -> None:
    """Callers that keep batches past the next `__next__` (K-step
    stacking) force copy-out mode."""
    self._plane.require_copies()

  def __iter__(self):
    return self

  def __next__(self) -> Batch:
    return self._split(TensorSpecStruct.from_flat_dict(dict(
        next(self._plane))))

  def close(self) -> None:
    self._plane.close()


@gin.configurable
class TFRecordInputGenerator(AbstractInputGenerator):
  """Streams parsed batches of tf.Example records from TFRecord files
  (see the module docstring for the pipeline)."""

  def __init__(self,
               file_patterns: Union[str, Sequence[str]] = "",
               batch_size: int = 32,
               shuffle_buffer_size: int = 1024,
               num_parallel_reads: int = 4,
               shuffle: bool = True,
               repeat: bool = True,
               seed: Optional[int] = None,
               num_workers: int = 0,
               plane_slots_per_worker: int = 2,
               plane_copy: Optional[bool] = None):
    super().__init__(batch_size=batch_size)
    if isinstance(file_patterns, str):
      file_patterns = [p for p in file_patterns.split(",") if p]
    self._file_patterns = list(file_patterns)
    self._shuffle_buffer_size = shuffle_buffer_size
    self._num_parallel_reads = num_parallel_reads
    self._shuffle = shuffle
    self._repeat = repeat
    self._seed = seed
    if num_workers < 0:
      raise ValueError(f"num_workers must be >= 0, got {num_workers}")
    self._num_workers = int(num_workers)
    self._plane_slots_per_worker = int(plane_slots_per_worker)
    self._plane_copy = plane_copy
    self._files_override: Optional[List[str]] = None

  def fix_seed(self, seed: int) -> None:
    """`AbstractInputGenerator.fix_seed`; raises with `num_workers` > 1,
    whose batches arrive in the data plane's completion order, which no
    seed fixes."""
    if self._num_workers > 1:
      raise ValueError(
          f"num_workers={self._num_workers}: the workers' batches arrive "
          "in completion order, so the ranks of a group would read "
          "different global batches; bind num_workers 0 or 1")
    super().fix_seed(seed)

  def _file_list(self) -> List[str]:
    if self._files_override is not None:
      return list(self._files_override)
    files: List[str] = []
    for pattern in self._file_patterns:
      matched = sorted(globlib.glob(pattern))
      if not matched and "*" not in pattern:
        matched = [pattern]
      files.extend(matched)
    if not files:
      raise ValueError(
          f"No TFRecord files matched patterns: {self._file_patterns}")
    return files

  def _records(self, mode: Mode) -> Iterator[bytes]:
    """Serialized records in pipeline order (files, interleave, repeat,
    shuffle buffer)."""
    train = mode == Mode.TRAIN
    rng = np.random.default_rng(self._seed)
    files = self._file_list()

    def passes():
      while True:
        order = ([files[i] for i in rng.permutation(len(files))]
                 if self._shuffle and train else files)
        empty = True
        for record in interleave(order, min(self._num_parallel_reads,
                                            len(files))):
          empty = False
          yield record
        if empty or not (self._repeat and train):
          return

    if self._shuffle and train:
      return shuffle_buffer(passes(), self._shuffle_buffer_size, rng)
    return passes()

  def _batched_dataset(self, mode: Mode, batch_size: int, parse_fn=None):
    """Batches (drop remainder) of serialized records, each parsed by
    `parse_fn` when given."""
    batch: List[bytes] = []
    for record in self._records(mode):
      batch.append(record)
      if len(batch) == batch_size:
        yield parse_fn(batch) if parse_fn is not None else batch
        batch = []

  def _merged_spec(self):
    """The feature and label specs merged for one parse per batch, and
    the two key sets."""
    feature_spec, label_spec = self.feature_spec, self.label_spec
    return (_merge_specs(feature_spec, label_spec),
            set(feature_spec.to_flat_dict()),
            set(label_spec.to_flat_dict()) if label_spec is not None
            else None)

  def _split_parsed(self, parsed, feature_keys, label_keys,
                    extra_feature_keys=()) -> Batch:
    flat = parsed.to_flat_dict()
    features = TensorSpecStruct.from_flat_dict(
        {k: v for k, v in flat.items()
         if k in feature_keys or k in extra_feature_keys})
    labels = None
    if label_keys is not None:
      labels = TensorSpecStruct.from_flat_dict(
          {k: v for k, v in flat.items() if k in label_keys})
    return features, labels

  # ---- parse/layout hooks (the episode subclass overrides all three) ----

  def _parse_fn(self, merged_struct):
    return lambda serialized: tfexample.graph_parse_example(
        serialized, merged_struct)

  def _extra_feature_keys(self) -> Tuple[str, ...]:
    """Parser-emitted keys forwarded into features beyond the spec."""
    return ()

  def _plane_layout(self, merged_struct, batch_size: int) -> WireLayout:
    """The shm-ring slot layout of one parsed batch."""
    return WireLayout.from_flat_specs(merged_struct.to_flat_dict(),
                                      batch_size)

  def _plane_stream(self, mode: Mode, batch_size: int) -> _PlaneStream:
    from tensor2robot_tpu_torch.data.plane import HostDataPlane

    merged_struct, feature_keys, label_keys = self._merged_spec()
    extra = self._extra_feature_keys()
    plane = HostDataPlane(
        _WorkerSource(self, mode, batch_size),
        self._plane_layout(merged_struct, batch_size),
        num_workers=self._num_workers,
        slots_per_worker=self._plane_slots_per_worker,
        copy=self._plane_copy)

    def split(parsed):
      return self._split_parsed(parsed, feature_keys, label_keys,
                                extra_feature_keys=extra)

    return _PlaneStream(plane, split)

  def _create_dataset(self, mode: Mode, batch_size: int) -> Iterator[Batch]:
    if self._num_workers > 0:
      return self._plane_stream(mode, batch_size)
    return self._inprocess_stream(mode, batch_size)

  def _inprocess_stream(self, mode: Mode, batch_size: int) -> Iterator[Batch]:
    merged_struct, feature_keys, label_keys = self._merged_spec()
    parse_fn = self._parse_fn(merged_struct)
    extra = self._extra_feature_keys()
    for flat in self._batched_dataset(mode, batch_size, parse_fn):
      yield self._split_parsed(TensorSpecStruct.from_flat_dict(flat),
                               feature_keys, label_keys,
                               extra_feature_keys=extra)


# The reference's name for the same class.
DefaultRecordInputGenerator = TFRecordInputGenerator


@gin.configurable
class TFRecordEpisodeInputGenerator(TFRecordInputGenerator):
  """Streams episode batches from tf.SequenceExample TFRecords: sequence
  specs come back `[B, sequence_length, ...]` (zero-padded or cut),
  with the true lengths under `features['sequence_length']`."""

  def __init__(self, sequence_length: int = 16,
               include_sequence_length: bool = True, **kwargs):
    super().__init__(**kwargs)
    self._sequence_length = int(sequence_length)
    self._include_sequence_length = include_sequence_length

  @property
  def sequence_length(self) -> int:
    return self._sequence_length

  def _parse_fn(self, merged_struct):
    return lambda s: tfexample.graph_parse_sequence_example(
        s, merged_struct, self._sequence_length)

  def _extra_feature_keys(self) -> Tuple[str, ...]:
    return ((tfexample.SEQUENCE_LENGTH_KEY,)
            if self._include_sequence_length else ())

  def _plane_layout(self, merged_struct, batch_size: int) -> WireLayout:
    # Sequence keys come back [B, T, ...]; the parser's true lengths
    # have no spec and ride as an extra field.
    flat = merged_struct.to_flat_dict()
    leading = {k: (self._sequence_length,)
               for k, s in flat.items() if s.is_sequence}
    return WireLayout.from_flat_specs(
        flat, batch_size, leading_dims=leading,
        extra_fields=((tfexample.SEQUENCE_LENGTH_KEY, (batch_size,),
                       "int32"),))


def write_tfrecord(path: str, examples: Sequence[dict], feature_spec,
                   label_spec=None) -> None:
  """Writes examples (flat dicts of unbatched arrays) to a TFRecord
  file, feature and label keys in one tf.Example each."""
  merged_struct = _merge_specs(feature_spec, label_spec)
  with TFRecordWriter(path) as writer:
    for example in examples:
      writer.write(tfexample.encode_example(example, merged_struct))


def write_episode_tfrecord(path: str, episodes: Sequence[dict], feature_spec,
                           label_spec=None) -> None:
  """Writes episodes (flat dicts; sequence keys hold [T, ...] arrays, T
  free per episode) as tf.SequenceExample records."""
  merged_struct = _merge_specs(feature_spec, label_spec)
  with TFRecordWriter(path) as writer:
    for episode in episodes:
      writer.write(tfexample.encode_sequence_example(episode, merged_struct))
