"""The port's preprocessor layer (`preprocessors/`) against the JAX
package's: `NoOpPreprocessor`'s in/out specs equal the model's in both
packages, the model's `preprocessor` defaults to it and takes
`preprocessor_cls`, input generators read its in-specs, and the train,
eval and predict steps run `preprocess` on the batch, as the JAX model
does (`abstract_model.py:327`, `:445`, `:471`)."""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.preprocessors import (  # noqa: E402
    NoOpPreprocessor as JaxNoOp,
)
from tensor2robot_tpu.specs import serialization as jax_serial  # noqa: E402
from tensor2robot_tpu_torch.data import (  # noqa: E402
    EpisodeInputGenerator,
    Mode,
)
from tensor2robot_tpu_torch.preprocessors import (  # noqa: E402
    AbstractPreprocessor,
    NoOpPreprocessor,
)
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    VRGripperTransformerModel,
)
from tensor2robot_tpu_torch.specs import (  # noqa: E402
    ExtendedTensorSpec as Spec,
    TensorSpecStruct,
    serialization,
)

_SMALL = dict(image_size=8, filters=(2, 4), embedding_size=8, width=16,
              depth=1, num_heads=2, max_context_length=8,
              attention_impl="reference", device_dtype=torch.float32)


def _feature_spec(mode):
  return TensorSpecStruct.from_flat_dict({
      "x": Spec((3,), np.float32, name="obs"),
      "y": Spec((2,), np.int32, is_optional=True)})


def _label_spec(mode):
  return TensorSpecStruct.from_flat_dict({"a": Spec((1,), np.float32)})


@pytest.mark.parametrize("mode", ["train", "eval", "predict"])
@pytest.mark.parametrize("method", [
    "get_in_feature_specification", "get_in_label_specification",
    "get_out_feature_specification", "get_out_label_specification"])
def test_noop_specs_equal_jax(method, mode):
  port = getattr(NoOpPreprocessor(_feature_spec, _label_spec), method)(
      Mode(mode))

  def jax_spec(fn):
    return lambda m: jax_serial.struct_from_dict(
        serialization.struct_to_dict(fn(m)))

  jax = getattr(JaxNoOp(jax_spec(_feature_spec), jax_spec(_label_spec)),
                method)(JaxMode(mode))
  assert serialization.struct_to_dict(port) == jax_serial.struct_to_dict(jax)


def test_noop_without_label_spec_and_feature_spec():
  pre = NoOpPreprocessor(_feature_spec)
  assert pre.get_in_label_specification(Mode.TRAIN) is None
  with pytest.raises(ValueError, match="No model feature"):
    NoOpPreprocessor().get_in_feature_specification(Mode.TRAIN)
  features, labels = {"x": torch.ones(1)}, None
  assert pre.preprocess(features, labels, Mode.TRAIN) == (features, labels)


class _Scale(AbstractPreprocessor):
  """Wire images arrive as float32 × 2 of the model's uint8 pixels: the
  preprocessor halves them back, and counts its calls."""

  calls = []

  def get_in_feature_specification(self, mode):
    flat = self.model_feature_specification(mode).to_flat_dict()
    flat["image"] = flat["image"].replace(dtype=np.float32,
                                          data_format=None)
    return TensorSpecStruct.from_flat_dict(flat)

  def get_in_label_specification(self, mode):
    return self.model_label_specification(mode)

  def get_out_feature_specification(self, mode):
    return self.model_feature_specification(mode)

  def get_out_label_specification(self, mode):
    return self.model_label_specification(mode)

  def preprocess(self, features, labels, mode, generator=None):
    _Scale.calls.append(mode)
    features = dict(features)
    features["image"] = (features["image"] / 2).to(torch.uint8)
    return features, labels


def _batch(model, seed=0, scale=1):
  rng = np.random.default_rng(seed)
  image = rng.integers(0, 128, (2, 4, 8, 8, 3), dtype=np.uint8)
  features = {"image": torch.from_numpy(image.astype(np.float32) * scale
                                        if scale != 1 else image),
              "gripper_pose": torch.randn(2, 4, 3),
              "sequence_length": torch.tensor([4, 2], dtype=torch.int32)}
  return features, {"action": torch.randn(2, 4, 3)}


def test_the_model_runs_its_preprocessor_in_every_step():
  plain = VRGripperTransformerModel(**_SMALL)
  assert isinstance(plain.preprocessor, NoOpPreprocessor)
  assert plain.preprocessor is plain.preprocessor
  scaled = VRGripperTransformerModel(preprocessor_cls=_Scale, **_SMALL)
  state = plain.create_train_state(seed=0, device="cpu")
  features, labels = _batch(plain)
  wire_features, _ = _batch(plain, scale=2)
  wire_features["gripper_pose"] = features["gripper_pose"]
  _Scale.calls.clear()
  want_state, want = plain.train_step(state, features, labels)
  got_state, got = scaled.train_step(state, wire_features, labels)
  assert _Scale.calls == [Mode.TRAIN]
  for key in want:
    torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
  want_eval = plain.eval_step(want_state, features, labels)
  got_eval = scaled.eval_step(got_state, wire_features, labels)
  assert _Scale.calls == [Mode.TRAIN, Mode.EVAL]
  torch.testing.assert_close(got_eval["loss"], want_eval["loss"], rtol=0,
                             atol=0)
  out = scaled.predict_step(got_state, wire_features)
  assert _Scale.calls[-1] == Mode.PREDICT
  torch.testing.assert_close(out["action"],
                             plain.predict_step(want_state, features)[
                                 "action"], rtol=0, atol=0)


def test_generators_read_the_preprocessors_in_specs():
  model = VRGripperTransformerModel(preprocessor_cls=_Scale, **_SMALL)
  gen = EpisodeInputGenerator([{"image": np.zeros((2, 8, 8, 3)),
                                "gripper_pose": np.zeros((2, 3)),
                                "action": np.zeros((2, 3))}],
                              sequence_length=2, batch_size=1)
  gen.set_specification_from_model(model, Mode.TRAIN)
  assert gen.feature_spec["image"].dtype == np.float32
  assert gen.label_spec.to_flat_dict() == model.get_label_specification(
      Mode.TRAIN).to_flat_dict()
  features, _ = next(gen.create_dataset(Mode.TRAIN))
  assert features["image"].dtype == np.float32
