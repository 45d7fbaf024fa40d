"""The port's TFRecord input generators, data plane and demo writer
against the JAX package's (which read through tf.data).

  * EVAL order over three files of different lengths (interleave cycle
    2, so a file's slot is refilled) and unshuffled TRAIN streams:
    batches exactly equal to JAX's, files written by either package;
  * shuffled TRAIN mode: each pass the same multiset of episodes;
  * `num_workers=1` equals `num_workers=0` bit for bit; two workers give
    the union of their file shards; a worker's error re-raises; close
    may be called again;
  * `collect_demo_episodes` of both packages at one seed: equal parsed
    arrays;
  * the slice: three f32 train steps of a small transformer from one
    TFRecord file in each package, losses within 1e-5 relative (the
    same math in other summation orders);
  * the shipped `train_vrgripper_transformer.gin` through the port's
    `run_t2r_trainer` on the CPU, two steps.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("tensorflow")

import torch  # noqa: E402

from tensor2robot_tpu.data import tfrecord_input_generator as jax_gen_lib  # noqa: E402,E501
from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu_torch.data import (  # noqa: E402
    HostDataPlane,
    Mode,
    TFRecordEpisodeInputGenerator,
    TFRecordInputGenerator,
    write_episode_tfrecord,
    write_tfrecord,
)
from tensor2robot_tpu_torch.data import tfrecord_input_generator as gen_lib  # noqa: E402,E501
from tensor2robot_tpu_torch.specs import (  # noqa: E402
    ExtendedTensorSpec as Spec,
    TensorSpecStruct,
    serialization,
)
from tensor2robot_tpu.specs import serialization as jax_serial  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 6


def _specs():
  features = TensorSpecStruct.from_flat_dict({
      "image": Spec((8, 8, 3), np.uint8, name="image", data_format="png",
                    is_sequence=True),
      "pose": Spec((3,), np.float32, name="gripper_pose", is_sequence=True),
      "episode": Spec((1,), np.int64),
  })
  labels = TensorSpecStruct.from_flat_dict({
      "action": Spec((2,), np.float32, name="action", is_sequence=True)})
  return features, labels


def _jax(struct):
  return jax_serial.struct_from_dict(serialization.struct_to_dict(struct))


def _episodes(start, n, seed):
  rng = np.random.default_rng(seed)
  out = []
  for i in range(start, start + n):
    steps = int(rng.integers(1, T + 4))
    out.append({
        "image": rng.integers(0, 256, (steps, 8, 8, 3), dtype=np.uint8),
        "pose": rng.standard_normal((steps, 3)).astype(np.float32),
        "episode": np.array([i]),
        "action": rng.standard_normal((steps, 2)).astype(np.float32)})
  return out


def _write_files(tmp_path, writer, sizes=(5, 2, 4)):
  features, labels = _specs()
  paths, start = [], 0
  for i, n in enumerate(sizes):
    path = str(tmp_path / f"demos-{i}.tfrecord")
    if writer == "port":
      write_episode_tfrecord(path, _episodes(start, n, i), features, labels)
    else:
      jax_gen_lib.write_episode_tfrecord(path, _episodes(start, n, i),
                                         _jax(features), _jax(labels))
    paths.append(path)
    start += n
  return str(tmp_path / "demos-*.tfrecord"), start


class _Model:
  """Spec getters only: what `set_specification_from_model` reads."""

  def __init__(self, jax=False):
    self._features, self._labels = _specs()
    if jax:
      self._features, self._labels = _jax(self._features), _jax(self._labels)

  def get_feature_specification(self, mode):
    return self._features

  def get_label_specification(self, mode):
    return self._labels


def _generators(pattern, **kwargs):
  kwargs = dict(dict(sequence_length=T, batch_size=2, num_parallel_reads=2),
                **kwargs)
  port = TFRecordEpisodeInputGenerator(file_patterns=pattern, **kwargs)
  port.set_specification_from_model(_Model(), Mode.TRAIN)
  jax_kwargs = {k: v for k, v in kwargs.items() if k != "num_workers"}
  jax = jax_gen_lib.TFRecordEpisodeInputGenerator(file_patterns=pattern,
                                                  **jax_kwargs)
  jax.set_specification_from_model(_Model(jax=True), JaxMode.TRAIN)
  return port, jax


def _flat_batch(batch):
  features, labels = batch
  return {**{"f/" + k: np.asarray(v) for k, v in
             features.to_flat_dict().items()},
          **{"l/" + k: np.asarray(v) for k, v in
             labels.to_flat_dict().items()}}


def _assert_batches_equal(got, want):
  assert len(got) == len(want)
  for g, w in zip(got, want):
    g, w = _flat_batch(g), _flat_batch(w)
    assert sorted(g) == sorted(w)
    for key in w:
      assert g[key].dtype == w[key].dtype, key
      np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _take(stream, n):
  return [next(stream) for _ in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_eval_order_over_three_files_equals_jax(tmp_path, writer):
  pattern, total = _write_files(tmp_path, writer)
  port, jax = _generators(pattern)
  got = list(port.create_dataset(Mode.EVAL))
  want = list(jax.create_dataset(JaxMode.EVAL))
  assert len(got) == total // 2
  _assert_batches_equal(got, want)
  order = [int(e) for f, _ in got for e in f["episode"][:, 0]]
  assert order != sorted(order)  # the interleave, not file order


def test_unshuffled_train_stream_repeats_as_jax(tmp_path):
  pattern, total = _write_files(tmp_path, "port")
  port, jax = _generators(pattern, shuffle=False)
  n = total + 3  # past one pass: batches straddle the repeat
  _assert_batches_equal(_take(port.create_dataset(Mode.TRAIN), n),
                        _take(jax.create_dataset(JaxMode.TRAIN), n))


def _episode_ids(batches):
  return sorted(int(e) for f, _ in batches for e in f["episode"][:, 0])


def test_shuffled_train_passes_hold_the_same_episodes(tmp_path):
  pattern, total = _write_files(tmp_path, "port", sizes=(4, 2, 6))
  port, jax = _generators(pattern, repeat=False, seed=3,
                          shuffle_buffer_size=5)
  got = list(port.create_dataset(Mode.TRAIN))
  want = list(jax.create_dataset(JaxMode.TRAIN))
  assert _episode_ids(got) == _episode_ids(want) == list(range(total))
  port_again, _ = _generators(pattern, repeat=False, seed=3,
                              shuffle_buffer_size=5)
  _assert_batches_equal(list(port_again.create_dataset(Mode.TRAIN)), got)
  assert [int(e) for f, _ in got for e in f["episode"][:, 0]] != list(
      range(total))
  # Repeated: every pass of 12 episodes is drawn through the buffer.
  port, _ = _generators(pattern, seed=3, shuffle_buffer_size=1)
  stream = port.create_dataset(Mode.TRAIN)
  for _ in range(2):
    assert _episode_ids(_take(stream, total // 2)) == list(range(total))


def test_one_worker_equals_the_in_process_stream(tmp_path):
  pattern, _ = _write_files(tmp_path, "port")
  inproc, _ = _generators(pattern, seed=5, shuffle_buffer_size=4)
  plane, _ = _generators(pattern, seed=5, shuffle_buffer_size=4,
                         num_workers=1)
  want = _take(inproc.create_dataset(Mode.TRAIN), 9)
  stream = plane.create_dataset(Mode.TRAIN)
  try:
    assert isinstance(stream, gen_lib._PlaneStream)
    assert not stream.release_after_transfer  # copies: no card here
    _assert_batches_equal(_take(stream, 9), want)
  finally:
    stream.close()
    stream.close()  # again: a no-op


def test_two_workers_serve_their_file_shards(tmp_path):
  pattern, total = _write_files(tmp_path, "port", sizes=(4, 2, 6))
  files = sorted(__import__("glob").glob(pattern))
  want = []
  for shard in (files[0::2], files[1::2]):
    gen, _ = _generators(",".join(shard))
    want += list(gen.create_dataset(Mode.EVAL))
  plane, _ = _generators(pattern, num_workers=2)
  got = list(plane.create_dataset(Mode.EVAL))
  assert _episode_ids(got) == _episode_ids(want) == list(range(total))


def test_a_worker_error_reraises_in_the_consumer(tmp_path):
  pattern, _ = _write_files(tmp_path, "port")
  path = sorted(__import__("glob").glob(pattern))[1]
  with open(path, "r+b") as f:  # flip a byte of the first record's data
    f.seek(20)
    byte = f.read(1)
    f.seek(20)
    f.write(bytes([byte[0] ^ 0xFF]))
  plane, _ = _generators(pattern, num_workers=1)
  stream = plane.create_dataset(Mode.EVAL)
  try:
    with pytest.raises(RuntimeError, match="data-plane worker"):
      list(stream)
    with pytest.raises(RuntimeError):  # latched
      next(stream)
  finally:
    stream.close()
  inproc, _ = _generators(pattern)
  with pytest.raises(ValueError, match="CRC-32C"):
    list(inproc.create_dataset(Mode.EVAL))


def test_the_plane_refuses_no_workers_and_checks_its_layout():
  layout = gen_lib.WireLayout([("x", (2, 3), "float32")])
  with pytest.raises(ValueError, match="num_workers"):
    HostDataPlane(lambda i, n: iter(()), layout, num_workers=0)
  with pytest.raises(ValueError, match="Field 'x'"):
    layout.check_batch({"x": np.zeros((2, 4), np.float32)})


def test_shm_ring_carries_bfloat16_as_its_bits():
  from tensor2robot_tpu_torch.data.shm_ring import ShmRing, WireLayout
  layout = WireLayout.from_flat_specs(
      {"b": Spec((3,), "bfloat16"), "a": Spec((2,), np.int16)}, 2,
      extra_fields=(("n", (2,), "int32"),))
  assert [f[0] for f in layout.fields] == ["a", "b", "n"]
  assert all(off % 64 == 0 for off in layout.offsets.values())
  ring = ShmRing(layout, 2)
  try:
    batch = {"a": np.arange(4, dtype=np.int16).reshape(2, 2),
             "b": torch.randn(2, 3).bfloat16(),
             "n": np.array([3, 4], np.int32)}
    ring.write(1, batch)
    views = ring.views(1)
    assert views["b"].dtype == torch.bfloat16
    assert torch.equal(views["b"], batch["b"])
    np.testing.assert_array_equal(views["a"], batch["a"])
    with pytest.raises(IndexError):
      ring.views(2)
  finally:
    ring.close()


def test_file_patterns_and_missing_files(tmp_path):
  gen = TFRecordInputGenerator(file_patterns=str(tmp_path / "none-*.rec"))
  gen.set_specification({"x": Spec((1,), np.float32)})
  with pytest.raises(ValueError, match="No TFRecord files"):
    next(gen.create_dataset(Mode.EVAL))
  gen = TFRecordInputGenerator(file_patterns=str(tmp_path / "absent.rec"))
  gen.set_specification({"x": Spec((1,), np.float32)})
  with pytest.raises(FileNotFoundError):
    next(gen.create_dataset(Mode.EVAL))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_flat_examples_equal_jax(tmp_path, writer):
  """TFRecordInputGenerator over tf.Example files: features and labels
  from one record, split after the parse."""
  features = {"x": Spec((2,), np.float32), "k": Spec((1,), np.int32)}
  labels = {"y": Spec((1,), np.float32, name="target")}
  rng = np.random.default_rng(0)
  examples = [{"x": rng.standard_normal(2), "k": [i],
               "y": rng.standard_normal(1)} for i in range(7)]
  path = str(tmp_path / "flat.tfrecord")
  if writer == "port":
    write_tfrecord(path, examples, features, labels)
  else:
    jax_gen_lib.write_tfrecord(path, examples,
                               _jax(TensorSpecStruct(features)),
                               _jax(TensorSpecStruct(labels)))
  port = TFRecordInputGenerator(file_patterns=path, batch_size=3)
  port.set_specification(features, labels)
  jax = jax_gen_lib.TFRecordInputGenerator(file_patterns=path, batch_size=3)
  jax.set_specification(_jax(TensorSpecStruct(features)),
                        _jax(TensorSpecStruct(labels)))
  _assert_batches_equal(list(port.create_dataset(Mode.EVAL)),
                        list(jax.create_dataset(JaxMode.EVAL)))


# ---- the demo writer ----


def test_collect_demo_episodes_equals_jax(tmp_path):
  from tensor2robot_tpu.research.vrgripper import vrgripper_models as jvm
  from tensor2robot_tpu.research.vrgripper.vrgripper_env import (
      collect_demo_episodes as jax_collect,
  )
  from tensor2robot_tpu.specs import as_sequence_specs as jax_as_sequence
  from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env import (
      _demo_specs,
      collect_demo_episodes,
  )
  from tensor2robot_tpu_torch.specs import as_sequence_specs
  port_path = collect_demo_episodes(str(tmp_path / "port" / "d.tfrecord"),
                                    num_episodes=6, image_size=16, seed=4)
  jax_path = jax_collect(str(tmp_path / "jax" / "d.tfrecord"),
                         num_episodes=6, image_size=16, seed=4)
  # The stand-in specs are the JAX regression model's, lifted.
  jax_model = jvm.VRGripperRegressionModel(image_size=16)
  for port_spec, jax_spec in zip(
      _demo_specs(16), (jax_model.get_feature_specification(JaxMode.TRAIN),
                        jax_model.get_label_specification(JaxMode.TRAIN))):
    assert serialization.struct_to_dict(as_sequence_specs(port_spec)) == \
        jax_serial.struct_to_dict(jax_as_sequence(jax_spec))
  features, labels = (as_sequence_specs(s) for s in _demo_specs(16))
  batches = []
  for path in (port_path, jax_path):
    gen = TFRecordEpisodeInputGenerator(file_patterns=path, batch_size=3,
                                        sequence_length=12)
    gen.set_specification(features, labels)
    batches.append(list(gen.create_dataset(Mode.EVAL)))
  _assert_batches_equal(*batches)
  assert len(batches[0]) == 2


# ---- the slice: train steps from a TFRecord file in both packages ----

_SMALL = dict(image_size=16, filters=(4, 8), embedding_size=16, width=32,
              depth=1, num_heads=2, max_context_length=16)


def test_three_train_steps_from_tfrecords_match_jax(tmp_path):
  """Three f32 Adam steps of a small transformer from one TFRecord file,
  each package reading it through its own generator: losses within 1e-5
  relative (f32, other summation orders)."""
  import jax
  import jax.numpy as jnp
  from tensor2robot_tpu.models import optimizers as jax_opt
  from tensor2robot_tpu.research.vrgripper import (
      VRGripperTransformerModel as JaxModel,
  )
  from tensor2robot_tpu_torch.models import convert, optimizers
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
      collect_demo_episodes,
  )
  path = collect_demo_episodes(str(tmp_path / "d.tfrecord"),
                               num_episodes=6, image_size=16, seed=1)
  jax_model = JaxModel(attention_impl="reference", device_dtype=jnp.float32,
                       create_optimizer_fn=functools.partial(
                           jax_opt.create_optimizer, learning_rate=1e-3),
                       **_SMALL)
  model = VRGripperTransformerModel(
      attention_impl="reference", device_dtype=torch.float32,
      create_optimizer_fn=functools.partial(optimizers.create_optimizer,
                                            learning_rate=1e-3), **_SMALL)
  kwargs = dict(file_patterns=path, batch_size=2, sequence_length=8,
                shuffle=False)
  jax_gen = jax_gen_lib.TFRecordEpisodeInputGenerator(**kwargs)
  jax_gen.set_specification_from_model(jax_model, JaxMode.TRAIN)
  gen = TFRecordEpisodeInputGenerator(**kwargs)
  gen.set_specification_from_model(model, Mode.TRAIN)
  jax_state = jax.jit(jax_model.create_train_state)(jax.random.PRNGKey(0))
  state = convert.convert_variables(
      {"params": jax.tree_util.tree_map(np.asarray, jax_state.params)})
  state = dataclasses.replace(state, opt_state=model.tx.init(state.params))
  jax_step = jax.jit(jax_model.train_step)
  losses = []
  for (jf, jl), (f, lab) in zip(
      _take(jax_gen.create_dataset(JaxMode.TRAIN), 3),
      _take(gen.create_dataset(Mode.TRAIN), 3)):
    jax_state, jax_metrics = jax_step(jax_state, jf, jl,
                                      jax.random.PRNGKey(1))
    state, metrics = model.train_step(
        state, {k: torch.from_numpy(v) for k, v in f.items()},
        {k: torch.from_numpy(v) for k, v in lab.items()})
    losses.append((float(metrics["loss"]), float(jax_metrics["loss"])))
  got, want = np.array(losses).T
  np.testing.assert_allclose(got, want, rtol=1e-5)
  assert state.step == int(jax_state.step) == 3


# ---- the shipped config on the CPU ----


def test_the_shipped_gin_trains_from_tfrecords_on_the_cpu(tmp_path):
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.research.vrgripper import collect_demo_episodes
  demos = collect_demo_episodes(str(tmp_path / "demos.tfrecord"),
                                num_episodes=20, seed=0)
  model_dir = str(tmp_path / "run")
  config = ("tensor2robot_tpu/research/vrgripper/configs/"
            "train_vrgripper_transformer.gin")
  try:
    code = run_t2r_trainer.main([
        "--gin_configs", os.path.join(_REPO, config),
        "--gin_bindings", f"train_eval_model.model_dir='{model_dir}'",
        "--gin_bindings",
        f"train/TFRecordEpisodeInputGenerator.file_patterns='{demos}'",
        "--gin_bindings", "train_eval_model.device='cpu'",
        "--gin_bindings", "train_eval_model.max_train_steps=2"])
    assert gin.query_parameter(
        "train/TFRecordEpisodeInputGenerator.sequence_length") == 32
  finally:
    gin.clear_config()
  assert code == 0
  with open(os.path.join(model_dir, "metrics_train.jsonl")) as f:
    records = [json.loads(line) for line in f]
  assert [r["step"] for r in records] == [2]
  assert np.isfinite(records[0]["payload"]["loss"])
  assert os.listdir(os.path.join(model_dir, "ckpt")) == ["2"]
