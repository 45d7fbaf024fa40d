"""The pipelined trunk (`layers/pipelined_transformer.py`) against the
JAX package's, on the CPU, at `tests/test_pipeline_config.py`'s sizes
(width 32, depth 4, 2 heads, max_len 16, 4 stages, 2 microbatches, f32,
reference attention).

  * The sequential fallback (no mesh) on params converted from flax's
    stacked ``stages`` subtree equals JAX's
    `PipelinedCausalTransformer(mesh=None)`: outputs and every gradient
    of a seeded projection of the outputs (the sum of `out · r`; the sum
    of the final LayerNorm's squares would leave the leaves before it
    next to no gradient) within 1e-5 (of each leaf's largest |value| for
    gradients).
  * `remat=True` equals `remat=False` (outputs and gradients).
  * The state paths and shapes are flax's (`models.convert.
    flax_param_paths` / `flax_param_shapes` against the flax tree), every
    ``stages`` leaf with a leading 4; the port's own init puts a leading
    4 on each stage leaf too, and a stage rank's init is that stage's
    slice of the one-device init.
  * JAX's errors: depth not splitting into the stages, width not
    splitting into heads, ring attention inside the stages, a sequence
    longer than max_len.
  * The VRGripper transformer with the pipelined trunk and no mesh
    trains and predicts as JAX's on its converted init (metrics 1e-5
    relative, gradients 1e-4 of each leaf's largest |value|), and
    raises JAX's errors for MoE beside stages and a mesh whose `stage`
    axis is not `pipeline_stages`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.layers.pipelined_transformer import (  # noqa: E402
    PipelinedCausalTransformer as JaxTrunk,
)
from tensor2robot_tpu_torch.layers.pipelined_transformer import (  # noqa: E402
    STAGE_PARAMS_NAME,
    PipelinedCausalTransformer,
)
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.models.abstract_model import (  # noqa: E402
    init_parameters,
)
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

_SIZES = dict(width=32, depth=4, num_heads=2, max_len=16, num_stages=4,
              num_microbatches=2)
_IN = 8


def _jax_trunk(**overrides):
  kwargs = dict(_SIZES, mesh=None, dtype=jnp.float32,
                attention_impl="reference")
  kwargs.update(overrides)
  return JaxTrunk(**kwargs)


def _port_trunk(**overrides):
  kwargs = dict(_SIZES, attention_impl="reference", dtype=torch.float32)
  kwargs.update(overrides)
  return PipelinedCausalTransformer(_IN, **kwargs)


@pytest.fixture(scope="module")
def jax_run():
  """JAX's fallback trunk: its variables, input, output and the
  gradients of sum(out · r)."""
  rng = np.random.default_rng(0)
  x = jnp.asarray(rng.standard_normal((8, 16, _IN)), jnp.float32)
  r = jnp.asarray(rng.standard_normal((8, 16, _SIZES["width"])),
                  jnp.float32)
  trunk = _jax_trunk()
  variables = jax.jit(trunk.init)(jax.random.PRNGKey(0), x)
  out = jax.jit(trunk.apply)(variables, x)
  grads = jax.jit(jax.grad(
      lambda v: jnp.sum(trunk.apply(v, x) * r)))(variables)
  return (jax.device_get(variables), (np.array(x), np.array(r)),
          np.asarray(out), jax.device_get(grads))


def _port_grads(trunk, params, inputs):
  x, r = (torch.from_numpy(a) for a in inputs)
  params = {k: v.clone().requires_grad_() for k, v in params.items()}
  out = torch.func.functional_call(trunk, params, (x,))
  (out * r).sum().backward()
  return out.detach().numpy(), {k: v.grad for k, v in params.items()}


def test_the_fallback_equals_jax_on_converted_params(jax_run):
  variables, x, want_out, want_grads = jax_run
  params = convert.convert_params(variables["params"])
  trunk = _port_trunk()
  out, grads = _port_grads(trunk, params, x)
  np.testing.assert_allclose(out, want_out, atol=1e-5, rtol=1e-5)
  want = convert.convert_params(want_grads["params"])
  assert sorted(grads) == sorted(want)
  for k, g in grads.items():
    scale = max(float(want[k].abs().max()), 1e-12)
    err = float((g - want[k]).abs().max()) / scale
    assert err <= 1e-5, (k, err)


def test_remat_equals_no_remat(jax_run):
  variables, x, _, _ = jax_run
  params = convert.convert_params(variables["params"])
  out, grads = _port_grads(_port_trunk(), params, x)
  out_r, grads_r = _port_grads(_port_trunk(remat=True), params, x)
  np.testing.assert_allclose(out_r, out, atol=1e-6, rtol=1e-6)
  for k in grads:
    torch.testing.assert_close(grads_r[k], grads[k], atol=1e-6, rtol=1e-6)


def test_state_paths_and_shapes_are_flax(jax_run):
  variables, _, _, _ = jax_run
  trunk = _port_trunk()
  paths = convert.flax_param_paths(trunk)
  shapes = convert.flax_param_shapes(trunk)
  flax = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
          for path, leaf in jax.tree_util.tree_leaves_with_path(
              variables["params"])}
  assert sorted(paths.values()) == sorted(flax)
  for name, path in paths.items():
    assert shapes[name] == flax[path], name
    if STAGE_PARAMS_NAME in path.split("/"):
      assert flax[path][0] == _SIZES["num_stages"], path
  stage_leaves = [p for p in flax if p.startswith("stages/")]
  assert len(stage_leaves) == 11  # one block a stage


def test_a_stage_rank_inits_its_slice_of_the_one_device_init():
  whole = _port_trunk()
  init_parameters(whole, torch.Generator().manual_seed(3))
  for stage in range(_SIZES["num_stages"]):
    mesh = mesh_lib.Mesh(axis_names=("stage",), shape={"stage": 4},
                         local_devices=("cpu",), world_size=4, rank=stage,
                         coords={"stage": stage})
    local = _port_trunk(mesh=mesh)
    init_parameters(local, torch.Generator().manual_seed(3))
    for name, leaf in local.named_parameters():
      want = dict(whole.named_parameters())[name]
      if name.startswith(STAGE_PARAMS_NAME + "."):
        assert leaf.shape[0] == 1
        want = want[stage:stage + 1]
      assert torch.equal(leaf, want), (stage, name)


@pytest.mark.parametrize("overrides,match", [
    (dict(depth=3), "num_stages"),
    (dict(num_heads=3), "heads"),
    (dict(attention_impl="ring_flash"), "pipeline stages"),
    (dict(attention_impl="ring"), "pipeline stages"),
])
def test_jax_errors(overrides, match):
  x = jnp.zeros((8, 8, _IN), jnp.float32)
  with pytest.raises(ValueError, match=match):
    _jax_trunk(**overrides).init(jax.random.PRNGKey(0), x)
  with pytest.raises(ValueError, match=match):
    _port_trunk(**overrides)


def test_a_sequence_longer_than_max_len_raises():
  with pytest.raises(ValueError, match="max_len"):
    _port_trunk()(torch.zeros((2, 17, _IN)))


# ---- the VRGripper transformer with the pipelined trunk ----

_MODEL = dict(image_size=16, filters=(8,), embedding_size=16, width=32,
              depth=4, num_heads=2, max_context_length=8,
              attention_impl="reference", pipeline_stages=4,
              pipeline_microbatches=2)


def test_the_pipelined_model_trains_as_jaxs():
  """`VRGripperTransformerModel(pipeline_stages=4)` without a mesh (the
  sequential fallback) on the JAX model's converted init: the train
  step's metrics within 1e-5 relative and every gradient within 1e-4 of
  its leaf's largest |value| (`tests/test_torch_vrgripper_moe.py`'s
  limits), the predictions within 1e-5."""
  from tensor2robot_tpu.research.vrgripper import (
      VRGripperTransformerModel as JaxModel,
  )
  from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
  )
  jax_model = JaxModel(device_dtype=jnp.float32, **_MODEL)
  jax_state = jax.jit(jax_model.create_train_state)(jax.random.PRNGKey(0))
  rng = np.random.default_rng(2)
  features = {
      "image": rng.integers(0, 255, (4, 8, 16, 16, 3)).astype(np.uint8),
      "gripper_pose": rng.standard_normal((4, 8, 3)).astype(np.float32),
      "sequence_length": np.array([8, 3, 5, 1], np.int64)}
  labels = {"action": rng.standard_normal((4, 8, 3)).astype(np.float32)}
  as_jax = lambda d: JaxStruct.from_flat_dict(  # noqa: E731
      {k: jnp.asarray(v) for k, v in d.items()})
  j_grads, _, j_metrics = jax.jit(jax_model.train_grads)(
      jax_state, as_jax(features), as_jax(labels), jax.random.PRNGKey(1))
  j_out = jax.jit(jax_model.predict_step)(jax_state, as_jax(
      {k: v for k, v in features.items() if k != "sequence_length"}))
  model = VRGripperTransformerModel(device_dtype=torch.float32, **_MODEL)
  state = convert.convert_variables(
      {"params": jax.tree_util.tree_map(np.asarray, jax_state.params)})
  as_torch = lambda d: {k: torch.from_numpy(v)  # noqa: E731
                        for k, v in d.items()}
  grads, _, metrics = model.train_grads(state, as_torch(features),
                                        as_torch(labels))
  assert set(metrics) == set(j_metrics)
  for key in metrics:
    np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]),
                               rtol=1e-5, err_msg=key)
  want = convert.convert_params(jax.device_get(j_grads))
  assert set(grads) == set(want)
  for key, g in grads.items():
    scale = max(float(want[key].abs().max()), 1e-12)
    assert float((g - want[key]).abs().max()) <= 1e-4 * scale, key
  out = model.predict_step(state, as_torch(
      {k: v for k, v in features.items() if k != "sequence_length"}))
  np.testing.assert_allclose(out["action"].numpy(),
                             np.asarray(j_out["action"]), atol=1e-5,
                             rtol=1e-5)


def test_the_models_jax_errors():
  from tensor2robot_tpu.parallel import create_mesh as jax_create_mesh
  from tensor2robot_tpu.research.vrgripper import (
      VRGripperTransformerModel as JaxModel,
  )
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
  )
  with pytest.raises(ValueError, match="mutually exclusive"):
    JaxModel(moe_experts=2, **_MODEL)
  with pytest.raises(ValueError, match="mutually exclusive"):
    VRGripperTransformerModel(moe_experts=2, **_MODEL)
  jax_mesh = jax_create_mesh({"data": 4, "stage": 2})
  with pytest.raises(ValueError, match="must equal the mesh's 'stage'"):
    JaxModel(mesh=jax_mesh, **_MODEL)
  mesh = mesh_lib.Mesh(axis_names=("data", "stage"),
                       shape={"data": 4, "stage": 2}, local_devices=(None,),
                       world_size=8, rank=0, coords={"data": 0, "stage": 0})
  with pytest.raises(ValueError, match="must equal the mesh's 'stage'"):
    VRGripperTransformerModel(mesh=mesh, **_MODEL)
