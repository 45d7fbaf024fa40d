"""Port's VRGripper transformer policy against the JAX package.

Small size (24×24 images, filters (8, 16), embedding 32, width 48,
depth 2, 2 heads, max_len 64). flax variables from the JAX model's own
init are converted (`models/convert.py`) and the same numpy inputs go
through both packages: spatial softmax and the image encoder, the
causal trunk, the whole `predict_step` (JAX with the reference backend
and with the Pallas flash kernel in interpret mode, patched in the test
as `tests/test_transformer.py` does), the closed-loop
`EpisodeContextPolicy`, and the numpy env.

Tolerances. f32: 1e-5 absolute (the same f32 math in other summation
orders). bf16: 3e-2 absolute on the actions, and 2e-2 absolute plus
2e-2 relative on the trunk's LayerNorm output (values up to ~3, where
one bf16 step is 2^-6). Dense layers, LayerNorm and gelu round to bf16
at each layer in both packages (one bf16 step is 2^-8 relative below
1.0); the two frameworks' kernels round at different places inside a
conv or a gelu, so an activation may land on the other bf16 neighbour
and move the residual stream by a step or two.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as fnn  # noqa: E402

import tensor2robot_tpu.layers.transformer as jax_tr  # noqa: E402
from tensor2robot_tpu.layers import (  # noqa: E402
    CausalTransformer as JaxTrunk,
    ImageEncoder as JaxImageEncoder,
)
from tensor2robot_tpu.layers.transformer import (  # noqa: E402
    MultiHeadAttention as JaxMHA,
)
from tensor2robot_tpu.layers.vision_layers import (  # noqa: E402
    spatial_softmax as jax_spatial_softmax,
)
from tensor2robot_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention as jax_flash_attention,
)
from tensor2robot_tpu.research.vrgripper import (  # noqa: E402
    VRGripperEnv as JaxEnv,
    VRGripperTransformerModel as JaxModel,
    collect_expert_episode as jax_collect,
    evaluate_gripper_policy as jax_evaluate,
)
from tensor2robot_tpu.specs import TensorSpecStruct  # noqa: E402
from tensor2robot_tpu_torch.layers import (  # noqa: E402
    CausalTransformer,
    ImageEncoder,
    spatial_softmax,
)
from tensor2robot_tpu_torch.layers.transformer import (  # noqa: E402
    LayerNorm,
    MultiHeadAttention,
)
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    VRGripperEnv,
    VRGripperTransformerModel,
    collect_expert_episode,
    evaluate_gripper_policy,
)

_SMALL = dict(image_size=24, filters=(8, 16), embedding_size=32, width=48,
              depth=2, num_heads=2, max_context_length=64)
_F32 = (jnp.float32, torch.float32)
_BF16 = (jnp.bfloat16, torch.bfloat16)


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _variables(module, *args, seed=0):
  variables = module.init(jax.random.PRNGKey(seed), *args)
  return jax.tree_util.tree_map(np.asarray, dict(variables))


def _bind(module, variables):
  state = convert.convert_variables(variables)
  module.load_state_dict(state.variables, strict=True)
  return module.eval()


# ---- vision layers ----


def test_spatial_softmax_matches_jax():
  """x runs along W, y along H; all xs first, then all ys."""
  rng = np.random.default_rng(0)
  feats = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
  temp = np.float32(0.7)
  want = jax_spatial_softmax(jnp.asarray(feats), jnp.asarray(temp))
  got = spatial_softmax(torch.from_numpy(feats), torch.tensor(temp))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
  # A one-hot map at row 1, column 6 of channel 0: x = +1 (last column),
  # y = -0.5 (second of five rows), in the [x..., y...] layout.
  hot = torch.full((1, 5, 7, 3), -1e4)
  hot[0, 1, 6, 0] = 1e4
  coords = spatial_softmax(hot)[0]
  assert coords.shape == (6,)
  assert coords[0].item() == pytest.approx(1.0)
  assert coords[3].item() == pytest.approx(-0.5)


@pytest.mark.parametrize("pooling,batch_norm", [
    ("spatial_softmax", False), ("spatial_softmax", True),
    ("mean", False), ("flatten", False)])
def test_image_encoder_matches_jax_f32(pooling, batch_norm):
  rng = np.random.default_rng(1)
  images = rng.uniform(0, 1, (3, 12, 12, 3)).astype(np.float32)
  jax_enc = JaxImageEncoder(filters=(4, 8), embedding_size=16,
                            pooling=pooling, use_batch_norm=batch_norm)
  variables = _variables(jax_enc, jnp.asarray(images))
  variables["params"]["ssoftmax"] = {"log_temperature": np.float32(0.3)} \
      if pooling == "spatial_softmax" else None
  if variables["params"]["ssoftmax"] is None:
    del variables["params"]["ssoftmax"]
  for name, stats in variables.get("batch_stats", {}).get(
      "tower", {}).items():
    stats["mean"] = rng.uniform(-0.2, 0.2, stats["mean"].shape).astype(
        np.float32)
    stats["var"] = rng.uniform(0.5, 1.5, stats["var"].shape).astype(
        np.float32)
  want = jax_enc.apply(variables, jnp.asarray(images))
  enc = _bind(ImageEncoder(3, filters=(4, 8), embedding_size=16,
                           pooling=pooling, use_batch_norm=batch_norm,
                           image_size=12), variables)
  with torch.no_grad():
    got = enc(torch.from_numpy(images))
  assert got.dtype == torch.float32
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_image_encoder_film_raises_naming_the_roadmap_item():
  """FiLM is ported (ROADMAP A10): `ImageEncoder(film=True)` needs the
  conditioning width up front (raises without it) and then matches the
  flax encoder with a conditioning vector, in f32 at 1e-5."""
  with pytest.raises(ValueError, match="conditioning_size"):
    ImageEncoder(3, film=True)
  rng = np.random.default_rng(2)
  images = rng.uniform(0, 1, (3, 12, 12, 3)).astype(np.float32)
  cond = rng.normal(size=(3, 5)).astype(np.float32)
  jax_enc = JaxImageEncoder(filters=(4, 8), embedding_size=16,
                            pooling="mean", use_batch_norm=False, film=True)
  variables = _variables(jax_enc, jnp.asarray(images), jnp.asarray(cond))
  want = jax_enc.apply(variables, jnp.asarray(images), jnp.asarray(cond))
  enc = _bind(ImageEncoder(3, filters=(4, 8), embedding_size=16,
                           pooling="mean", use_batch_norm=False, film=True,
                           conditioning_size=5), variables)
  with torch.no_grad():
    got = enc(torch.from_numpy(images), torch.from_numpy(cond))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


# ---- transformer trunk ----


def _trunk_pair(dtypes, depth=2, seed=0, impl="reference"):
  jdt, tdt = dtypes
  x = np.random.default_rng(seed).standard_normal((2, 16, 8)).astype(
      np.float32)
  jax_net = JaxTrunk(width=48, depth=depth, num_heads=2, max_len=64,
                     attention_impl="reference", dtype=jdt)
  variables = _variables(jax_net, jnp.asarray(x), seed=seed)
  net = _bind(CausalTransformer(8, width=48, depth=depth, num_heads=2,
                                max_len=64, attention_impl=impl,
                                dtype=tdt), variables)
  return jax_net, variables, net, x


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_causal_transformer_matches_jax_f32(impl):
  jax_net, variables, net, x = _trunk_pair(_F32, impl=impl)
  want = jax_net.apply(variables, jnp.asarray(x))
  with torch.no_grad():
    got = net(torch.from_numpy(x))
  assert got.dtype == torch.float32 and got.shape == (2, 16, 48)
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_causal_transformer_is_causal():
  """Perturbing step 7 must not change outputs before it."""
  _, _, net, x = _trunk_pair(_F32, seed=1)
  x2 = x.copy()
  x2[0, 7] += 5.0
  with torch.no_grad():
    base = net(torch.from_numpy(x))
    pert = net(torch.from_numpy(x2))
  np.testing.assert_allclose(_np(pert[0, :7]), _np(base[0, :7]), atol=1e-6)
  assert (pert[0, 7:] - base[0, 7:]).abs().max() > 1e-3


def test_causal_transformer_bf16_keeps_a_bf16_residual_stream():
  jax_net, variables, net, x = _trunk_pair(_BF16, seed=2)
  want = jax_net.apply(variables, jnp.asarray(x))
  seen = []
  # A block returns (residual stream, MoE aux loss or None).
  hook = net.block1.register_forward_hook(
      lambda mod, inp, out: seen.append((out[0].dtype, out[1])))
  with torch.no_grad():
    got = net(torch.from_numpy(x))
  hook.remove()
  assert seen == [(torch.bfloat16, None)] and got.dtype == torch.float32
  np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


def test_layer_norm_epsilon_is_flax_1e_6():
  """A row whose variance (1e-6) is the size of the epsilon: flax's
  1e-6 and torch's default 1e-5 give visibly different outputs."""
  x = (np.random.default_rng(3).standard_normal((4, 48)) * 1e-3).astype(
      np.float32)
  ln = fnn.LayerNorm(dtype=jnp.bfloat16)
  variables = _variables(ln, jnp.asarray(x))
  variables["params"]["scale"] = np.linspace(0.5, 1.5, 48).astype(
      np.float32)
  want = ln.apply(variables, jnp.asarray(x))
  port = LayerNorm(48, torch.bfloat16)
  port.load_state_dict(convert.convert_params(variables["params"]))
  with torch.no_grad():
    got = port(torch.from_numpy(x))
    torch_default = torch.nn.functional.layer_norm(
        torch.from_numpy(x), (48,), port.weight, port.bias)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=0)
  assert np.abs(_np(torch_default) - _np(want)).max() > 0.1


def test_qkv_split_takes_q_from_the_first_columns():
  """flax reshapes qkv to [b, t, 3h, d] and splits axis 2: q is the
  first h·d output columns. A wrong split order fails here."""
  rng = np.random.default_rng(4)
  x = rng.standard_normal((1, 16, 48)).astype(np.float32)
  jax_mha = JaxMHA(num_heads=2, head_dim=24, dtype=jnp.float32)
  variables = _variables(jax_mha, jnp.asarray(x))
  want = jax_mha.apply(variables, jnp.asarray(x))
  mha = _bind(MultiHeadAttention(48, 2, 24, dtype=torch.float32), variables)
  with torch.no_grad():
    got = mha(torch.from_numpy(x))
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_gelu_is_the_tanh_approximation():
  x = np.linspace(-4, 4, 101).astype(np.float32)
  want = fnn.gelu(jnp.asarray(x))
  got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
  exact = torch.nn.functional.gelu(torch.from_numpy(x))
  assert np.abs(_np(exact) - _np(want)).max() > 1e-4


# ---- the whole model ----


def _models(dtypes, impl="reference", **widths):
  jdt, tdt = dtypes
  widths = dict(_SMALL, **widths)
  jax_model = JaxModel(attention_impl="reference", device_dtype=jdt,
                       **widths)
  state = jax_model.create_inference_state(jax.random.PRNGKey(0))
  variables = {"params": jax.tree_util.tree_map(np.asarray, state.params)}
  # Move the positions and temperature off their init so both count.
  rng = np.random.default_rng(5)
  trunk = variables["params"]["trunk"]
  trunk["positions"] = rng.normal(0, 0.5, trunk["positions"].shape).astype(
      np.float32)
  variables["params"]["obs_encoder"]["image_encoder"]["ssoftmax"][
      "log_temperature"] = np.float32(-0.4)
  jax_state = state.replace(params=jax.tree_util.tree_map(
      jnp.asarray, variables["params"]))
  model = VRGripperTransformerModel(attention_impl=impl, device_dtype=tdt,
                                    **widths)
  return jax_model, jax_state, model, convert.convert_variables(variables)


def _episode_batch(batch=2, steps=16, seed=6):
  rng = np.random.default_rng(seed)
  return {"image": rng.integers(0, 256, (batch, steps, 24, 24, 3),
                                dtype=np.uint8),
          "gripper_pose": rng.uniform(-0.4, 0.4, (batch, steps, 3)).astype(
              np.float32)}


def _jax_predict(jax_model, jax_state, feats):
  batch = TensorSpecStruct.from_flat_dict(
      {k: jnp.asarray(v) for k, v in feats.items()})
  return jax_model.predict_step(jax_state, batch)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_predict_step_matches_jax_reference_f32(impl):
  jax_model, jax_state, model, state = _models(_F32, impl)
  feats = _episode_batch()
  want = _jax_predict(jax_model, jax_state, feats)
  got = model.predict_step(
      state, {k: torch.from_numpy(v) for k, v in feats.items()})
  assert set(got) == {"action", "inference_output"}
  assert got["action"].shape == (2, 16, 3)
  np.testing.assert_allclose(_np(got["action"]), _np(want["action"]),
                             atol=1e-5, rtol=0)


def test_predict_step_matches_jax_flash_interpret_f32(monkeypatch):
  """The JAX model with its Pallas flash kernel in interpret mode
  (8×8 blocks) against the port's flash path (its plain version on
  the CPU) on the same converted weights."""
  jax_model, jax_state, model, state = _models(_F32, "flash")
  monkeypatch.setattr(
      jax_tr, "_attend", lambda q, k, v, *, impl, causal, mesh:
      jax_flash_attention(q, k, v, causal=causal, block_q=8, block_k=8,
                          interpret=True))
  feats = _episode_batch(seed=7)
  want = _jax_predict(jax_model, jax_state, feats)
  got = model.predict_step(
      state, {k: torch.from_numpy(v) for k, v in feats.items()})
  np.testing.assert_allclose(_np(got["action"]), _np(want["action"]),
                             atol=1e-5, rtol=0)


def test_predict_step_at_head_dim_16_matches_jax_flash_interpret_f32(
    monkeypatch):
  """Head dim 16, the default model's (there width 64 over 4 heads; here
  width 32 over 2): the JAX model with its Pallas flash kernel in
  interpret mode against the port's flash path on the same weights."""
  jax_model, jax_state, model, state = _models(_F32, "flash", width=32)
  assert model.create_network().trunk.block0.attn.head_dim == 16
  monkeypatch.setattr(
      jax_tr, "_attend", lambda q, k, v, *, impl, causal, mesh:
      jax_flash_attention(q, k, v, causal=causal, block_q=8, block_k=8,
                          interpret=True))
  feats = _episode_batch(seed=9)
  want = _jax_predict(jax_model, jax_state, feats)
  got = model.predict_step(
      state, {k: torch.from_numpy(v) for k, v in feats.items()})
  np.testing.assert_allclose(_np(got["action"]), _np(want["action"]),
                             atol=1e-5, rtol=0)


def test_predict_step_matches_jax_bf16():
  jax_model, jax_state, model, state = _models(_BF16)
  feats = _episode_batch(seed=8)
  want = _jax_predict(jax_model, jax_state, feats)
  got = model.predict_step(
      state, {k: torch.from_numpy(v) for k, v in feats.items()})
  assert got["action"].dtype == torch.float32
  np.testing.assert_allclose(_np(got["action"]), _np(want["action"]),
                             atol=3e-2, rtol=0)


def test_create_inference_state_defaults_to_the_card():
  model = VRGripperTransformerModel(**_SMALL)
  with pytest.raises(RuntimeError, match="cuda"):
    model.create_inference_state(0)
  state = model.create_inference_state(0, device="cpu")
  assert state.params["trunk.positions"].shape == (64, 48)
  assert 0.01 < state.params["trunk.positions"].std().item() < 0.03


@pytest.mark.parametrize("kwargs", [
    dict(pipeline_stages=2, attention_impl="ring"),
    dict(moe_experts=4, pipeline_stages=2),
    dict(attention_impl="ring")])
def test_unported_options_raise_at_construction(kwargs):
  """A pipelined trunk takes neither ring attention nor MoE blocks
  (JAX's errors). MoE on one device, the pipelined trunk and ring
  attention are ported (tests/test_torch_vrgripper_moe.py,
  tests/test_torch_pipelined_transformer.py,
  tests/test_torch_ring_attention.py): a ring model builds, and mesh-free
  it runs "auto" (no parameter depends on the backend)."""
  if "pipeline_stages" in kwargs:
    match = "pipeline stages" if "attention_impl" in kwargs else (
        "mutually exclusive")
    with pytest.raises(ValueError, match=match):
      VRGripperTransformerModel(**dict(_SMALL, **kwargs))
    return
  model = VRGripperTransformerModel(**dict(_SMALL, **kwargs))
  assert model.without_mesh() is model  # no mesh: itself, impl "ring"
  state = model.create_inference_state(0, device="cpu")
  auto = VRGripperTransformerModel(**_SMALL)
  assert set(state.params) == set(auto.create_inference_state(
      0, device="cpu").params)


# ---- the closed-loop policy and the env ----


def test_episode_context_policy_matches_jax():
  """Both policies over the same observations: 10 steps through a
  context of 8 (the window slides), a reset, then 3 more steps."""
  jax_model, jax_state, model, state = _models(_F32)
  jax_policy = jax_model.make_context_policy(jax_state, context_length=8)
  policy = model.make_context_policy(state, context_length=8, device="cpu")
  env = VRGripperEnv(image_size=24, seed=3)
  for episode, steps in enumerate((10, 3)):
    obs = env.reset()
    jax_policy.reset()
    policy.reset()
    for _ in range(steps):
      batch = {k: v[None] for k, v in obs.items()}
      want = jax_policy(batch)["action"]
      got = policy(batch)["action"]
      assert isinstance(got, np.ndarray) and got.shape == (1, 3)
      np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
      obs, _, _ = env.step(got[0])
  assert policy.steps == 13 and policy.resets == 2


def test_env_frames_are_bitwise_those_of_jax():
  port, ref = VRGripperEnv(image_size=24, seed=11), JaxEnv(image_size=24,
                                                            seed=11)
  actions = np.random.default_rng(0).uniform(-1, 1, (20, 3)).astype(
      np.float32)
  for i, action in enumerate(actions):
    if i % 7 == 0:
      a, b = port.reset(), ref.reset()
    else:
      (a, ra, da), (b, rb, db) = port.step(action), ref.step(action)
      assert (ra, da) == (rb, db)
    for key in ("image", "gripper_pose"):
      assert a[key].dtype == b[key].dtype
      np.testing.assert_array_equal(a[key], b[key])


def test_expert_episodes_and_evaluation_match_jax():
  ep = collect_expert_episode(VRGripperEnv(image_size=24, seed=2),
                              action_noise=0.1, min_steps=4,
                              rng=np.random.default_rng(1))
  ref = jax_collect(JaxEnv(image_size=24, seed=2), action_noise=0.1,
                    min_steps=4, rng=np.random.default_rng(1))
  assert set(ep) == set(ref)
  for key in ep:
    np.testing.assert_array_equal(ep[key], ref[key])

  def toward_center(batch):
    return {"action": np.concatenate(
        [-batch["gripper_pose"][:, :2] * 5, np.ones((1, 1))], axis=1)}

  assert evaluate_gripper_policy(toward_center, num_episodes=3,
                                 image_size=24, seed=4) == jax_evaluate(
      toward_center, num_episodes=3, image_size=24, seed=4)


def test_convert_layer_norm_batch_norm_and_raw_params():
  """`scale` becomes torch's `weight` except in a module with batch
  statistics (BatchNorm); raw params keep their names and shapes."""
  rng = np.random.default_rng(9)
  f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
  positions = f(8, 4)
  state = convert.convert_variables({
      "params": {"trunk": {"positions": positions,
                           "ln_out": {"scale": f(4), "bias": f(4)}},
                 "tower": {"bn_0": {"scale": f(3), "bias": f(3)}},
                 "ssoftmax": {"log_temperature": np.float32(0.3)}},
      "batch_stats": {"tower": {"bn_0": {"mean": f(3), "var": f(3)}}}})
  assert set(state.params) == {
      "trunk.positions", "trunk.ln_out.weight", "trunk.ln_out.bias",
      "tower.bn_0.scale", "tower.bn_0.bias", "ssoftmax.log_temperature"}
  assert set(state.batch_stats) == {"tower.bn_0.mean", "tower.bn_0.var"}
  np.testing.assert_array_equal(state.params["trunk.positions"].numpy(),
                                positions)
  assert state.params["ssoftmax.log_temperature"].shape == ()
