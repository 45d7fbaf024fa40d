"""Port's ResNet and FiLM (`layers/resnet.py`, `layers/vision_layers.py`)
against the JAX package's flax modules.

Small size: stage sizes (1, 1), 8 filters, 16×16 and 17×17 images (an
even and an odd input, so the stride-2 SAME pads differ), batch 3. Flax
variables from the JAX module's own init are perturbed (every batch-norm
scale, bias and running statistic drawn from a seed, so that no branch
is the zero-initialized identity) and converted (`models/convert.py`);
the same numpy images go through both packages.

Tolerances. f32: 1e-5 of the output's largest magnitude (the same f32
math in other summation orders). bf16: 2e-2 of the output's largest
magnitude (both frameworks round each conv and batch norm to bf16, at
different places inside a conv, so an activation may land on the other
bf16 neighbour of a value up to ~4, where a step is 2^-6). Batch
statistics in train mode are f32 in both and held at 1e-5 (f32) or 2e-2
(bf16) of their largest magnitude.

Pinned traps (ROADMAP): 21, flax's SAME max pool pads with −inf, (0, 1)
on an even input; 22, each block's last batch norm starts at scale 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as fnn  # noqa: E402

from tensor2robot_tpu.layers import resnet as jax_resnet  # noqa: E402
from tensor2robot_tpu.layers.vision_layers import FiLM as JaxFiLM  # noqa: E402
from tensor2robot_tpu_torch.layers import (  # noqa: E402
    FiLM,
    ResNet,
    max_pool_same,
    resnet18,
    resnet34,
    resnet50,
)
from tensor2robot_tpu_torch.layers.resnet import (  # noqa: E402
    BottleneckBlock,
    ResNetBlock,
)
from tensor2robot_tpu_torch.layers.vision_layers import (  # noqa: E402
    collect_batch_stats,
)
from tensor2robot_tpu_torch.models import convert  # noqa: E402

_DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
           "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
  got, want = _np(got), _np(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(float(np.abs(want).max()), 1e-6)
  err = float(np.abs(got - want).max())
  assert err <= tol * scale, f"{what}: max |Δ| {err} > {tol} × {scale}"


def _perturbed(variables, seed):
  """Every BN scale/bias/mean/var drawn from `seed` (no zero branch)."""
  rng = np.random.default_rng(seed)
  out = jax.tree_util.tree_map(np.asarray, variables)

  def walk(tree, kind):
    for key, value in tree.items():
      if isinstance(value, dict):
        walk(value, kind)
      elif kind == "params" and key in ("scale", "bias") and value.ndim == 1:
        tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32) \
            if key == "scale" else rng.uniform(-0.3, 0.3, value.shape
                                               ).astype(np.float32)
      elif kind == "batch_stats":
        tree[key] = (rng.uniform(-0.2, 0.2, value.shape) if key == "mean"
                     else rng.uniform(0.5, 1.5, value.shape)
                     ).astype(np.float32)

  walk(out["params"], "params")
  if "batch_stats" in out:
    walk(out["batch_stats"], "batch_stats")
  return out


def _pair(block, dtype_name, size, use_film=False, seed=0):
  jdt, tdt, tol = _DTYPES[dtype_name]
  rng = np.random.default_rng(seed)
  images = rng.uniform(0, 1, (3, size, size, 3)).astype(np.float32)
  cond = rng.normal(size=(3, 5)).astype(np.float32) if use_film else None
  jax_net = jax_resnet.ResNet(
      stage_sizes=(1, 1), num_filters=8,
      block_cls=(jax_resnet.BottleneckBlock if block == "bottleneck"
                 else jax_resnet.ResNetBlock),
      use_film=use_film, return_spatial=True, dtype=jdt)
  args = (jnp.asarray(images),) + (
      (jnp.asarray(cond),) if use_film else ())
  variables = _perturbed(jax_net.init(jax.random.PRNGKey(seed), *args),
                         seed + 1)
  net = ResNet(stage_sizes=(1, 1), num_filters=8,
               block_cls=BottleneckBlock if block == "bottleneck"
               else ResNetBlock,
               use_film=use_film, conditioning_size=5 if use_film else 0,
               return_spatial=True, dtype=tdt)
  state = convert.convert_variables(variables)
  net.load_state_dict(state.variables, strict=True)
  return jax_net, variables, net, images, cond, args, tol


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_eval_matches_flax(block, size, dtype_name):
  jax_net, variables, net, images, _, args, tol = _pair(
      block, dtype_name, size)
  want_pooled, want_spatial = jax_net.apply(variables, *args)
  with torch.no_grad():
    got_pooled, got_spatial = net.eval()(torch.from_numpy(images))
  assert got_pooled.dtype == torch.float32
  _close(got_pooled, want_pooled, tol, "pooled")
  _close(got_spatial, want_spatial, tol, "spatial")


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("size", [16, 17])
def test_resnet_train_mode_outputs_and_batch_stats(size, dtype_name):
  jax_net, variables, net, images, _, args, tol = _pair(
      "basic", dtype_name, size, seed=3)
  (want, _), mutated = jax_net.apply(variables, *args, train=True,
                                     mutable=["batch_stats"])
  with torch.no_grad():
    got, _ = net.train()(torch.from_numpy(images))
  _close(got, want, tol, "pooled")
  got_stats = collect_batch_stats(net)
  want_stats = convert.convert_batch_stats(
      jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))
  assert set(got_stats) == set(want_stats)
  for key, value in want_stats.items():
    _close(got_stats[key], value, tol, key)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_film_matches_flax(block, dtype_name):
  jax_net, variables, net, images, cond, args, tol = _pair(
      block, dtype_name, 16, use_film=True, seed=5)
  assert "film" in variables["params"]["stage0_block0"]
  want, _ = jax_net.apply(variables, *args)
  with torch.no_grad():
    got, _ = net.eval()(torch.from_numpy(images), torch.from_numpy(cond))
  _close(got, want, tol, "pooled")


def test_film_layer_matches_flax():
  rng = np.random.default_rng(7)
  x = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
  cond = rng.normal(size=(2, 5)).astype(np.float32)
  jax_film = JaxFiLM()
  variables = jax_film.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(cond))
  want = jax_film.apply(variables, jnp.asarray(x), jnp.asarray(cond))
  film = FiLM(5, 6)
  film.load_state_dict(convert.convert_variables(
      jax.tree_util.tree_map(np.asarray, variables)).variables)
  with torch.no_grad():
    got = film(torch.from_numpy(x), torch.from_numpy(cond))
  _close(got, want, 1e-6, "film")
  # The (1 + γ) form: zero projection weights give the identity.
  with torch.no_grad():
    film.film_proj.weight.zero_()
    np.testing.assert_array_equal(
        _np(film(torch.from_numpy(x), torch.from_numpy(cond))), x)


@pytest.mark.parametrize("size", [6, 7])
def test_max_pool_pads_with_minus_inf_like_flax(size):
  """Trap 21: on all-negative inputs a zero pad (or torch's symmetric
  `MaxPool2d(padding=1)`) would change the answer; flax pads XLA's SAME
  way, (0, 1) on an even input and (1, 1) on an odd one, with −inf."""
  rng = np.random.default_rng(size)
  x = -rng.uniform(1, 2, (2, size, size, 3)).astype(np.float32)
  want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                      padding="SAME")
  got = max_pool_same(torch.from_numpy(x))
  np.testing.assert_array_equal(_np(got), _np(want))
  zero_padded = torch.nn.functional.max_pool2d(
      torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1
  ).permute(0, 2, 3, 1)
  if size % 2 == 0:
    assert zero_padded.shape == got.shape
    assert not np.array_equal(_np(zero_padded), _np(want))


def test_block_last_batch_norm_starts_at_zero_scale():
  """Trap 22: `bn2` (basic) and `bn3` (bottleneck) start at scale 0 in
  both packages, so a fresh block is relu(shortcut)."""
  x = jnp.zeros((1, 8, 8, 8))
  basic = jax_resnet.ResNetBlock(filters=8).init(jax.random.PRNGKey(0), x)
  bottleneck = jax_resnet.BottleneckBlock(filters=8).init(
      jax.random.PRNGKey(0), x)
  assert not np.asarray(basic["params"]["bn2"]["scale"]).any()
  assert not np.asarray(bottleneck["params"]["bn3"]["scale"]).any()
  assert np.asarray(basic["params"]["bn1"]["scale"]).all()
  port_basic = ResNetBlock(8, 8)
  port_bottleneck = BottleneckBlock(8, 8)
  assert not port_basic.bn2.scale.any()
  assert not port_bottleneck.bn3.scale.any()
  assert port_basic.bn1.scale.all() and port_bottleneck.bn2.scale.all()
  x = torch.rand(2, 5, 5, 8)
  with torch.no_grad():
    np.testing.assert_allclose(_np(port_basic.eval()(x)),
                               _np(torch.relu(x)), atol=1e-6)


def test_stem_conv_pads_three_and_parameter_names_are_flax():
  net = resnet18(num_filters=8)
  names = set(dict(net.named_parameters()))
  assert {"conv_init.weight", "bn_init.scale", "stage0_block0.conv1.weight",
          "stage0_block0.bn2.scale", "stage1_block0.proj.weight",
          "stage1_block0.bn_proj.bias", "stage3_block1.conv2.weight"} <= names
  assert "stage0_block0.proj.weight" not in names
  with torch.no_grad():
    pooled = net.eval()(torch.rand(1, 32, 32, 3))
  assert pooled.shape == (1, 64)
  assert resnet34(num_filters=4).block_names[-1] == "stage3_block2"
  assert resnet50(num_filters=4).out_channels == 4 * 8 * 4
  head = ResNet(stage_sizes=(1,), num_filters=4, num_classes=3)
  with torch.no_grad():
    assert head.eval()(torch.rand(2, 9, 9, 3)).shape == (2, 3)
