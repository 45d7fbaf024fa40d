"""Port's GraspingQNetwork on converted flax weights against flax `apply`.

The same numpy image/action/extras go through `encode`, `__call__`,
`score_population` and `pool_population` of both packages. Batch-norm
statistics and affine params are perturbed away from their init so the
BN fold in the linearity-split merge is actually exercised.

Tolerances: f32 to 1e-5 (the same f32 arithmetic, other conv/GEMM
summation orders). bf16: 2e-2 absolute on features and logits below
2.5 in magnitude — one bf16 step there (8 significant bits) is at most
2^-6 = 0.0156, the move an activation makes when it rounds to the
other neighbour in one framework. (Measured on this case: ≤ 1.3e-4.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.research.qtopt.t2r_models import (  # noqa: E402
    GraspingQModel as JaxModel,
)
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (  # noqa: E402
    GraspingQModel,
)

_TINY = dict(image_size=16, torso_filters=(8, 8), head_filters=(8, 8),
             dense_sizes=(16,), action_dim=3)


def _perturbed_variables(jax_model, seed=0):
  state = jax_model.create_inference_state(jax.random.PRNGKey(seed))
  rng = np.random.default_rng(seed)
  params = jax.tree_util.tree_map(np.asarray, state.params)
  stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
  for name in params:
    if "_bn_" in name:
      params[name]["scale"] = rng.uniform(0.5, 1.5, params[name][
          "scale"].shape).astype(np.float32)
      params[name]["bias"] = rng.uniform(-0.3, 0.3, params[name][
          "bias"].shape).astype(np.float32)
      stats[name]["mean"] = rng.uniform(-0.3, 0.3, stats[name][
          "mean"].shape).astype(np.float32)
      stats[name]["var"] = rng.uniform(0.5, 2.0, stats[name][
          "var"].shape).astype(np.float32)
  variables = {"params": params}
  if stats:
    variables["batch_stats"] = stats
  return variables


def _outputs(kwargs, jax_dtype, torch_dtype, batch=2, population=5,
             seed=0):
  jax_model = JaxModel(device_dtype=jax_dtype, **kwargs)
  model = GraspingQModel(device_dtype=torch_dtype, **kwargs)
  variables = _perturbed_variables(jax_model, seed)
  network = model.bind(convert.convert_variables(variables))
  rng = np.random.default_rng(seed + 1)
  size, a_dim = kwargs.get("image_size", 64), kwargs.get("action_dim", 4)
  feats = {"image": rng.integers(0, 256, (batch, size, size, 3),
                                 dtype=np.uint8),
           "action": rng.uniform(-1, 1, (batch, a_dim)).astype(np.float32)}
  for key, shape in kwargs.get("extra_state_features", {}).items():
    feats[key] = rng.standard_normal((batch,) + shape).astype(np.float32)
  extras = {k: v for k, v in feats.items() if k not in ("image", "action")}
  actions = rng.uniform(-1, 1, (batch, population, a_dim)).astype(
      np.float32)

  net = jax_model.network
  enc = net.apply(variables, feats["image"], method="encode")
  want = {
      "encode": enc,
      "q": net.apply(variables, feats)["q_value"],
      "score": net.apply(variables, enc, extras, actions,
                         method="score_population"),
      "pool": net.apply(variables, enc, extras, actions,
                        method="pool_population"),
  }
  t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
  with torch.no_grad():
    tenc = network.encode(torch.from_numpy(feats["image"]))
    got = {
        "encode": tenc,
        "q": network(t(feats))["q_value"],
        "score": network.score_population(tenc, t(extras),
                                          torch.from_numpy(actions)),
        "pool": network.pool_population(tenc, t(extras),
                                        torch.from_numpy(actions)),
    }
  return got, {k: np.asarray(v.astype(jnp.float32)) for k, v in want.items()}


def _assert_close(got, want, atol, rtol):
  for key in want:
    g = got[key].float().numpy()
    assert g.shape == want[key].shape, key
    np.testing.assert_allclose(g, want[key], atol=atol, rtol=rtol,
                               err_msg=key)


@pytest.mark.parametrize("variant", [
    dict(extra_state_features={"height": (1,)}),
    dict(use_batch_norm=False),
    dict(space_to_depth=2),
    dict(head_filters=()),
], ids=["extra_feature", "no_batch_norm", "space_to_depth", "no_head"])
def test_tiny_network_f32(variant):
  kwargs = dict(_TINY, **variant)
  got, want = _outputs(kwargs, jnp.float32, torch.float32)
  _assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_extras_concatenate_in_sorted_key_order():
  """Two extras declared out of order: both packages feed them to the
  action embedding sorted by key, so converted weights line up."""
  kwargs = dict(_TINY, extra_state_features={"zeta": (2,), "alpha": (1,)})
  got, want = _outputs(kwargs, jnp.float32, torch.float32, seed=3)
  _assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_full_width_model_f32():
  """`GraspingQModel()`'s widths (64×64 images, torso (32, 64), head
  (64, 64), dense (64, 64), A=4) at batch 2."""
  got, want = _outputs({}, jnp.float32, torch.float32, population=8)
  _assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_tiny_network_bf16():
  kwargs = dict(_TINY, extra_state_features={"height": (1,)})
  got, want = _outputs(kwargs, jnp.bfloat16, torch.bfloat16)
  for key in ("encode", "pool"):
    assert got[key].dtype == torch.bfloat16, key
  _assert_close(got, want, atol=2e-2, rtol=0)


def test_convert_layouts_and_bf16_leaves():
  """HWIO→OIHW, [in,out]→[out,in], and bf16 leaves read bit-exactly."""
  import ml_dtypes

  rng = np.random.default_rng(0)
  kernel = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
  dense = rng.standard_normal((6, 7)).astype(ml_dtypes.bfloat16)
  state = convert.convert_variables({
      "params": {"c": {"kernel": kernel},
                 "q_head": {"dense_0": {"kernel": dense,
                                        "bias": np.zeros(7, np.float32)}}},
      "batch_stats": {"bn": {"mean": np.ones(5, np.float32),
                             "var": np.ones(5, np.float32)}}})
  np.testing.assert_array_equal(state.params["c.weight"].numpy(),
                                kernel.transpose(3, 2, 0, 1))
  np.testing.assert_array_equal(state.params["q_head.dense_0.weight"].numpy(),
                                dense.astype(np.float32).T)
  assert state.params["q_head.dense_0.weight"].dtype == torch.float32
  assert set(state.batch_stats) == {"bn.mean", "bn.var"}


def test_same_padding_matches_xla_at_stride_two():
  """XLA pads (0, 1) for a 3×3 stride-2 conv on an even input; odd
  inputs pad (1, 1)."""
  from tensor2robot_tpu_torch.layers.vision_layers import _same_pads

  assert _same_pads(16, 3, 2) == (0, 1)
  assert _same_pads(15, 3, 2) == (1, 1)
  assert _same_pads(16, 3, 1) == (1, 1)


def test_eval_bn_affine_is_the_batch_norm_forward():
  from tensor2robot_tpu_torch.research.qtopt.networks import (
      BatchNorm,
      _eval_bn_affine,
  )

  rng = np.random.default_rng(2)
  bn = BatchNorm(6, torch.float32).eval()  # running statistics
  with torch.no_grad():
    for t, lo, hi in ((bn.scale, 0.5, 1.5), (bn.bias, -1, 1),
                      (bn.mean, -1, 1), (bn.var, 0.5, 2)):
      t.copy_(torch.from_numpy(rng.uniform(lo, hi, 6).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((3, 2, 2, 6)).astype(
        np.float32))
    scale, shift = _eval_bn_affine(bn)
    torch.testing.assert_close(x * scale + shift, bn(x), rtol=1e-6,
                               atol=1e-6)
