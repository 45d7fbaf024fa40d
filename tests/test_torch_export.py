"""The port's export (`tensor2robot_tpu_torch/export/`) against the JAX
package's, on the CPU.

The JAX exporter writes a jax2tf SavedModel; the port writes one
`torch.export` program per platform (here `program.cpu.pt2`) with the
same spec assets. No TF export runs here: each program, loaded by
`SavedModelPredictor(device="cpu")`, is held against the JAX model's
jitted `predict_step` on the same converted params (`models/convert.py`)
and the same numpy inputs, and the asset file against what JAX's
`specs.serialize_assets` writes for the same model. Also ported: the
export cases of `tests/test_export_predict.py` (the newest directory),
`tests/test_transformer.py` (the proto-signature warning, the
SequenceExample signature), and the flash forward's `torch.library`
registration that lets an exported program launch the kernel.

Tolerances: f32 throughout; the same math in other summation orders,
so outputs agree to 1e-5 of their largest |value| (the transformer's and
grasp2vec's 2e-5: more layers); programs of one model and two calls of
one program agree exactly.
"""

import dataclasses
import functools
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu import specs as jax_specs  # noqa: E402
from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.export import (  # noqa: E402
    abstract_export_generator as jax_export,
)
from tensor2robot_tpu.research import grasp2vec as jax_g2v  # noqa: E402
from tensor2robot_tpu.research.vrgripper import (  # noqa: E402
    VRGripperTransformerModel as JaxTransformer,
)
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct  # noqa: E402
from tensor2robot_tpu.utils import mocks as jax_mocks  # noqa: E402
from tensor2robot_tpu_torch import specs  # noqa: E402
from tensor2robot_tpu_torch.data import Mode, tfexample  # noqa: E402
from tensor2robot_tpu_torch.export import (  # noqa: E402
    SavedModelExportGenerator,
    check_signature_keys,
    claim_timestamped_export_dir,
    create_default_exporters,
    latest_export_dir,
    load_signatures,
    sanitize_signature_key,
)
from tensor2robot_tpu_torch.meta_learning import MAMLModel  # noqa: E402
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.predictors import SavedModelPredictor  # noqa: E402
from tensor2robot_tpu_torch.research import grasp2vec as g2v  # noqa: E402
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    VRGripperTransformerModel,
)
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402

# The module (the package exports the function under the same name).
fa = importlib.import_module("tensor2robot_tpu_torch.ops.flash_attention")
_CPU = ("cpu",)
_IMG = 12
_TRANSFORMER = dict(image_size=_IMG, filters=(4, 8), embedding_size=16,
                    width=32, depth=2, num_heads=2, max_context_length=16)
_G2V = dict(image_size=16, embedding_size=16, stage_sizes=(1, 1),
            num_filters=8)


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
  got, want = _np(got), _np(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  np.testing.assert_allclose(
      got, want, atol=tol * max(1e-12, float(np.abs(want).max())), rtol=0,
      err_msg=what)


def _jax_struct(flat):
  return JaxStruct.from_flat_dict({k: jnp.asarray(v) for k, v in
                                   flat.items()})


def _export(model, state, model_dir, **kwargs):
  return SavedModelExportGenerator(platforms=_CPU, **kwargs).export(
      model, state, str(model_dir))


def _predictor(export_dir, **kwargs):
  predictor = SavedModelPredictor(os.path.dirname(export_dir),
                                  device="cpu", **kwargs)
  assert predictor.restore(timeout_secs=0)
  return predictor


# ---- the protocol (abstract_export_generator) ----


@pytest.mark.parametrize("keys,collide", [
    (["a/b", "c"], False), (["a/b", "a_b"], True), (["x", "x"], False)])
def test_signature_keys_as_jax(keys, collide):
  assert [sanitize_signature_key(k) for k in keys] == [
      jax_export.sanitize_signature_key(k) for k in keys]
  for check in (check_signature_keys, jax_export.check_signature_keys):
    if collide:
      with pytest.raises(ValueError, match="sanitize"):
        check(keys)
    else:
      check(keys)


def test_latest_export_dir_picks_newest(tmp_path):
  base = str(tmp_path / "exports")
  assert latest_export_dir(base) is None
  for name in ("100", "200", "50", "300.tmp", "notes"):
    os.makedirs(os.path.join(base, name))
  assert latest_export_dir(base).endswith("200")
  assert latest_export_dir(base) == jax_export.latest_export_dir(base)


def test_claims_in_one_second_get_distinct_dirs(tmp_path):
  base = str(tmp_path / "exports")
  claims = [claim_timestamped_export_dir(base) for _ in range(3)]
  finals = [c[0] for c in claims]
  assert len(set(finals)) == 3
  assert all(os.path.isdir(tmp) and tmp == final + ".tmp"
             for final, tmp in claims)
  # Unpublished claims are invisible to pollers.
  assert latest_export_dir(base) is None
  os.rename(claims[1][1], claims[1][0])
  assert latest_export_dir(base) == claims[1][0]


# ---- the flash forward as one operator ----


def _qkv(b=2, t=9, h=2, d=8, seed=0):
  rng = np.random.default_rng(seed)
  return [torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
          for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_operator_on_the_cpu_is_the_plain_version(causal):
  q, k, v = _qkv()
  out, lse = torch.ops.t2r.flash_attention_fwd(q, k, v, causal)
  want_out, want_lse = fa.flash_attention_reference(q, k, v, causal=causal)
  assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
  assert out.is_contiguous() and lse.is_contiguous()
  got = fa.flash_attention_with_lse(q, k, v, causal=causal)
  assert torch.equal(got[0], want_out) and torch.equal(got[1], want_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_operator_fake_shapes(dtype):
  from torch._subclasses.fake_tensor import FakeTensorMode
  with FakeTensorMode():
    q = torch.empty((3, 17, 4, 24), dtype=dtype)
    out, lse = torch.ops.t2r.flash_attention_fwd(q, q, q, True)
  assert out.shape == q.shape and out.dtype == dtype
  assert lse.shape == (3, 4, 17) and lse.dtype == torch.float32


def test_flash_forward_is_one_node_of_an_exported_program():
  class Attend(torch.nn.Module):

    def forward(self, q, k, v):
      return fa.flash_attention(q, k, v, causal=True)

  q, k, v = _qkv()
  with torch.no_grad():
    program = torch.export.export(Attend(), (q, k, v))
  targets = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
  assert targets.count("t2r.flash_attention_fwd.default") == 1
  assert torch.equal(program.module()(q, k, v),
                     fa.flash_attention_reference(q, k, v, causal=True)[0])


def test_flash_backward_still_flows_through_the_operator():
  q, k, v = (x.requires_grad_() for x in _qkv())
  fa.flash_attention(q, k, v, causal=True).square().sum().backward()
  rq, rk, rv = (x.detach().clone().requires_grad_() for x in (q, k, v))
  fa.flash_attention_reference(rq, rk, rv, causal=True)[0].square().sum(
  ).backward()
  for got, want in ((q, rq), (k, rk), (v, rv)):
    _close(got.grad, want.grad, 1e-5)


# ---- programs against the JAX predict_step ----


@functools.lru_cache(maxsize=None)
def _jax_mock():
  model = jax_mocks.MockT2RModel()
  state = jax.jit(model.create_inference_state)(jax.random.PRNGKey(3))
  return model, state, jax.jit(model.predict_step)


def _port_state(jax_state, **kwargs):
  return convert.convert_variables(jax.tree_util.tree_map(np.asarray, {
      "params": jax_state.params, "batch_stats": jax_state.batch_stats}),
                                   **kwargs)


@pytest.fixture(scope="module")
def mock_export(tmp_path_factory):
  _, jax_state, _ = _jax_mock()
  model = MockT2RModel()
  state = _port_state(jax_state, step=7)
  model_dir = tmp_path_factory.mktemp("mock")
  return model, state, _export(model, state, model_dir,
                               serving_max_batch=8)


@pytest.mark.parametrize("batch", [1, 5])
def test_mock_program_matches_jax_predict(mock_export, batch):
  _, jax_state, jax_predict = _jax_mock()
  predictor = _predictor(mock_export[2])
  features = {"x": np.random.default_rng(batch).normal(
      size=(batch, 3)).astype(np.float32)}
  got = predictor.predict(features)
  want = jax_predict(jax_state, _jax_struct(features))
  assert set(got) == set(want)
  for key in want:
    _close(got[key], want[key], 1e-5, key)


def test_export_layout_and_manifest(mock_export):
  _, _, export_dir = mock_export
  assert sorted(os.listdir(export_dir)) == [
      "assets.extra", "program.cpu.pt2", "signatures.json"]
  manifest = load_signatures(export_dir)
  assert manifest["platforms"] == ["cpu"]
  assert manifest["signatures"] == {
      "serving_default": {"inputs": ["x"]},
      "parse_tf_example": {"inputs": ["examples"]}}
  assert manifest["dims"] == {"cpu": {"x": {"0": [1, None]}}}


def _assets(export_dir):
  with open(os.path.join(export_dir, "assets.extra",
                         specs.ASSET_FILENAME)) as f:
    return f.read()


def _jax_feature_and_label_specs(jax_model):
  return (jax_specs.flatten_spec_structure(
      jax_model.preprocessor.get_in_feature_specification(JaxMode.PREDICT)),
          jax_model.preprocessor.get_in_label_specification(JaxMode.PREDICT))


def test_mock_assets_equal_jax(mock_export):
  jax_model, _, _ = _jax_mock()
  feature_spec, label_spec = _jax_feature_and_label_specs(jax_model)
  want = jax_specs.serialize_assets(
      feature_spec, label_spec=label_spec, global_step=7,
      extra={"serving": {"max_batch": 8, "bucket_sizes": [1, 2, 4, 8],
                         "max_wait_us": 200}})
  got = _assets(mock_export[2])
  assert got == want
  assert json.loads(got) == json.loads(want)


def test_each_package_reads_the_others_assets(mock_export, tmp_path):
  export_dir = mock_export[2]
  path = os.path.join(export_dir, "assets.extra", specs.ASSET_FILENAME)
  theirs = jax_specs.read_assets(path)
  assert theirs["global_step"] == 7
  assert set(theirs["feature_spec"].to_flat_dict()) == {"x"}
  jax_model, _, _ = _jax_mock()
  feature_spec, label_spec = _jax_feature_and_label_specs(jax_model)
  jax_path = str(tmp_path / specs.ASSET_FILENAME)
  jax_specs.write_assets(jax_path, feature_spec, label_spec=label_spec,
                         global_step=3)
  ours = specs.read_assets(jax_path)
  assert ours["global_step"] == 3
  flat = ours["feature_spec"].to_flat_dict()
  assert flat["x"].shape == (3,) and flat["x"].dtype == np.float32
  assert set(ours["label_spec"].to_flat_dict()) == {"target"}


def test_parse_tf_example_serves_what_serving_default_serves(mock_export):
  predictor = _predictor(mock_export[2])
  proto = _predictor(mock_export[2], signature="parse_tf_example")
  rng = np.random.default_rng(11)
  features = {"x": rng.normal(size=(4, 3)).astype(np.float32)}
  serialized = [tfexample.encode_example(
      {"x": features["x"][i]}, proto.feature_specification)
                for i in range(4)]
  got = proto.predict({"examples": serialized})
  want = predictor.predict(features)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key])


@functools.lru_cache(maxsize=None)
def _jax_transformer():
  model = JaxTransformer(attention_impl="reference",
                         device_dtype=jnp.float32, **_TRANSFORMER)
  state = jax.jit(model.create_inference_state)(jax.random.PRNGKey(0))
  return model, state, jax.jit(model.predict_step)


def _episode_batch(b, t, seed):
  rng = np.random.default_rng(seed)
  return {"image": rng.integers(0, 256, (b, t, _IMG, _IMG, 3),
                                dtype=np.uint8),
          "gripper_pose": rng.normal(size=(b, t, 3)).astype(np.float32)}


def _port_transformer(impl="auto"):
  return VRGripperTransformerModel(attention_impl=impl,
                                   device_dtype=torch.float32,
                                   **_TRANSFORMER)


_SEQUENCE_EXAMPLE_LENGTH = 8


@pytest.fixture(scope="module")
def transformer_export(tmp_path_factory):
  _, jax_state, _ = _jax_transformer()
  model = _port_transformer()
  state = _port_state(jax_state)
  export_dir = _export(model, state, tmp_path_factory.mktemp("tr"),
                       sequence_example_length=_SEQUENCE_EXAMPLE_LENGTH)
  return model, state, export_dir


@pytest.mark.parametrize("b,t", [(1, 5), (3, 5), (1, 16), (3, 16)])
def test_transformer_program_matches_jax_at_two_batches_and_two_lengths(
    transformer_export, b, t):
  """One program serves B = 1, 3 and T = 5, 16 (the context's end)."""
  _, jax_state, jax_predict = _jax_transformer()
  predictor = _predictor(transformer_export[2])
  batch = _episode_batch(b, t, seed=10 * b + t)
  got = predictor.predict(batch)
  want = jax_predict(jax_state, _jax_struct(batch))
  assert set(got) == set(want) and got["action"].shape == (b, t, 3)
  for key in want:
    _close(got[key], want[key], 2e-5, key)


def test_transformer_dims_are_recorded_and_held(transformer_export):
  dims = load_signatures(transformer_export[2])["dims"]["cpu"]
  # The learned positions hold 16 steps: the time axis is capped there
  # (torch.export bounds the image's; the pose's must equal it).
  assert dims["image"] == {"0": [1, None], "1": [1, 16]}
  assert dims["gripper_pose"]["0"] == [1, None]
  assert dims["gripper_pose"]["1"] in ([1, 16], [1, None])
  predictor = _predictor(transformer_export[2])
  with pytest.raises(ValueError, match=r"axis 1 has size 17.*\[1, 16\]"):
    predictor.predict(_episode_batch(1, 17, seed=0))


def test_cpu_program_holds_the_attention_its_device_picks(
    transformer_export, tmp_path):
  """"auto" traced on the CPU is the plain attention; "flash" keeps the
  operator, whose CPU implementation is the plain version: one answer."""
  _, state, auto_dir = transformer_export
  flash_dir = _export(_port_transformer("flash"), state, tmp_path)
  batch = _episode_batch(2, 6, seed=5)
  graphs, outputs = {}, {}
  for impl, export_dir in (("auto", auto_dir), ("flash", flash_dir)):
    program = torch.export.load(os.path.join(export_dir, "program.cpu.pt2"))
    graphs[impl] = [str(n.target) for n in program.graph.nodes
                    if n.op == "call_function"]
    outputs[impl] = _predictor(export_dir).predict(batch)["action"]
  assert not any("t2r." in t for t in graphs["auto"])
  assert graphs["flash"].count("t2r.flash_attention_fwd.default") == 2
  _close(outputs["flash"], outputs["auto"], 1e-5)


class _SequenceMock(MockT2RModel):
  """The mock over [B, T, 3] episodes: a sequence spec, a tiny net."""

  def get_feature_specification(self, mode):
    st = specs.TensorSpecStruct()
    st.x = specs.ExtendedTensorSpec(shape=(3,), dtype=np.float32, name="x",
                                    is_sequence=True)
    return st

  def predict_step(self, state, features):
    x = features["x"]
    b, t = x.shape[:2]
    out = super().predict_step(state, {"x": x.reshape(b * t, 3)})
    return {k: v.reshape(b, t, -1) for k, v in out.items()}


def test_default_export_skips_proto_signature_with_warning(tmp_path):
  model = _SequenceMock()
  state = model.create_inference_state(device="cpu")
  with pytest.warns(RuntimeWarning, match="SequenceExample"):
    export_dir = _export(model, state, tmp_path)
  manifest = load_signatures(export_dir)
  assert set(manifest["signatures"]) == {"serving_default"}
  assert manifest["dims"]["cpu"] == {"x": {"0": [1, None], "1": [1, None]}}
  features = {"x": np.ones((2, 5, 3), np.float32)}
  got = _predictor(export_dir).predict(features)["inference_output"]
  want = model.predict_step(state, {"x": torch.ones(2, 5, 3)})[
      "inference_output"].numpy()
  np.testing.assert_array_equal(got, want)


def test_sequence_example_signature_round_trip(transformer_export):
  t = _SEQUENCE_EXAMPLE_LENGTH
  export_dir = transformer_export[2]
  manifest = load_signatures(export_dir)
  assert manifest["signatures"]["parse_tf_sequence_example"] == {
      "inputs": ["examples"], "sequence_example_length": t}
  proto = _predictor(export_dir, signature="parse_tf_sequence_example")
  batch = _episode_batch(2, t, seed=29)
  serialized = [tfexample.encode_sequence_example(
      {k: v[i] for k, v in batch.items()}, proto.feature_specification)
                for i in range(2)]
  got = proto.predict({"examples": serialized})
  want = _predictor(export_dir).predict(batch)
  for key in want:
    _close(got[key], want[key], 1e-6, key)


def test_sequence_assets_equal_jax(transformer_export):
  jax_model, _, _ = _jax_transformer()
  feature_spec, label_spec = _jax_feature_and_label_specs(jax_model)
  want = jax_specs.serialize_assets(feature_spec, label_spec=label_spec,
                                    global_step=0)
  assert json.loads(_assets(transformer_export[2])) == json.loads(want)


@functools.lru_cache(maxsize=None)
def _jax_g2v():
  model = jax_g2v.Grasp2VecModel(device_dtype=jnp.float32, **_G2V)
  state = jax.jit(model.create_inference_state, static_argnums=1)(
      jax.random.PRNGKey(0), 2)
  return model, state, jax.jit(model.predict_step)


def test_grasp2vec_program_matches_jax(tmp_path):
  _, jax_state, jax_predict = _jax_g2v()
  model = g2v.Grasp2VecModel(device_dtype=torch.float32, **_G2V)
  export_dir = _export(model, _port_state(jax_state), tmp_path)
  predictor = _predictor(export_dir)
  rng = np.random.default_rng(4)
  for b in (1, 3):
    features = {k: rng.integers(0, 256, (b, 16, 16, 3), dtype=np.uint8)
                for k in ("pregrasp_image", "postgrasp_image",
                          "goal_image")}
    got = predictor.predict(features)
    want = jax_predict(jax_state, _jax_struct(features))
    assert set(got) == set(want)
    for key in want:
      _close(got[key], want[key], 2e-5, key)


# ---- the exporter's rules ----


def test_batch_polymorphic_false_traces_a_static_batch(tmp_path):
  model = MockT2RModel()
  state = model.create_inference_state(device="cpu")
  export_dir = _export(model, state, tmp_path, batch_polymorphic=False)
  assert load_signatures(export_dir)["dims"]["cpu"] == {"x": {"0": [1, 1]}}
  predictor = _predictor(export_dir)
  assert predictor.predict({"x": np.zeros((1, 3), np.float32)})[
      "inference_output"].shape == (1, 2)
  with pytest.raises(ValueError, match=r"\[1, 1\]"):
    predictor.predict({"x": np.zeros((2, 3), np.float32)})


def _maml():
  return MAMLModel(base_model=MockT2RModel(hidden_sizes=(8,)),
                   num_inner_steps=2, inner_lr=0.5,
                   num_condition_samples_per_task=4,
                   num_inference_samples_per_task=4)


def test_function_transforms_refuse_a_polymorphic_batch(tmp_path):
  model = _maml()
  state = model.create_inference_state(device="cpu")
  with pytest.raises(ValueError, match="batch_polymorphic=False"):
    _export(model, state, tmp_path)
  # A failed export publishes nothing and leaves no claim behind.
  assert os.listdir(tmp_path / "export") == []


def test_an_export_that_specializes_the_batch_raises(tmp_path):
  class FixedBatch(MockT2RModel):

    def predict_step(self, state, features):
      out = super().predict_step(state, features)
      if features["x"].shape[0] == 2:  # a branch on the batch size
        return out
      return {k: v + 1 for k, v in out.items()}

  model = FixedBatch()
  state = model.create_inference_state(device="cpu")
  with pytest.raises(ValueError, match="specializes an axis"):
    _export(model, state, tmp_path)
  assert os.listdir(tmp_path / "export") == []


def test_platforms_are_checked():
  with pytest.raises(ValueError, match="platforms"):
    SavedModelExportGenerator(platforms=("tpu",))
  with pytest.raises(ValueError, match="platforms"):
    SavedModelExportGenerator(platforms=())


def test_the_cards_program_needs_a_card(tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  model = MockT2RModel()
  state = model.create_inference_state(device="cpu")
  with pytest.raises(RuntimeError, match="cuda"):
    SavedModelExportGenerator().export(model, state, str(tmp_path))
  assert os.listdir(tmp_path / "export") == []


def test_create_default_exporters_as_jax(tmp_path):
  exporters = create_default_exporters(MockT2RModel(),
                                       export_dir_base=str(tmp_path / "e"),
                                       platforms=_CPU, serving_max_batch=4)
  assert len(exporters) == 1
  assert isinstance(exporters[0], SavedModelExportGenerator)
  assert exporters[0].export_dir_base("ignored") == str(tmp_path / "e")


def test_export_reads_a_host_copy_of_the_state(tmp_path):
  """The exporter copies the state before tracing: a later write to the
  trainer's buffers does not reach the published program."""
  model = MockT2RModel()
  state = model.create_inference_state(device="cpu")
  features = {"x": np.ones((2, 3), np.float32)}
  want = model.predict_step(state, {"x": torch.ones(2, 3)})[
      "inference_output"].numpy()
  export_dir = _export(model, state, tmp_path)
  for value in state.params.values():
    value.add_(1.0)
  got = _predictor(export_dir).predict(features)["inference_output"]
  np.testing.assert_array_equal(got, want)


def test_bf16_outputs_come_back_as_f32(tmp_path):
  model = MockT2RModel(device_dtype=torch.bfloat16)
  state = model.create_inference_state(device="cpu")
  export_dir = _export(model, state, tmp_path)
  out = _predictor(export_dir).predict({"x": np.ones((2, 3), np.float32)})
  assert out["inference_output"].dtype == np.float32
  want = model.predict_step(state, {"x": torch.ones(2, 3)})[
      "inference_output"].float().numpy()
  np.testing.assert_array_equal(out["inference_output"], want)


def test_the_export_carries_the_step(tmp_path):
  model = MockT2RModel()
  state = dataclasses.replace(model.create_inference_state(device="cpu"),
                              step=12)
  export_dir = _export(model, state, tmp_path)
  assert _predictor(export_dir).global_step == 12


def test_exports_on_two_threads_take_turns(tmp_path):
  """torch.export's tracing modes are process-wide: the async hook's
  worker and the end-of-training exporter, exporting at once, must not
  corrupt each other's trace."""
  import threading
  model = _SequenceMock()
  state = model.create_inference_state(device="cpu")
  paths, errors = [], []

  def export(i):
    try:
      paths.append(_export(model, state, tmp_path / str(i)))
    except Exception as e:  # noqa: BLE001 — reported below
      errors.append(repr(e))

  threads = [threading.Thread(target=export, args=(i,)) for i in range(2)]
  for thread in threads:
    thread.start()
  for thread in threads:
    thread.join(timeout=120)
  assert not any(t.is_alive() for t in threads)
  assert not errors and len(paths) == 2
  features = {"x": np.ones((1, 4, 3), np.float32)}
  outs = [_predictor(p).predict(features)["inference_output"] for p in paths]
  np.testing.assert_array_equal(outs[0], outs[1])
