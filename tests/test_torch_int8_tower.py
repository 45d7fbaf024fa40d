"""Port's int8 CEM tower against the JAX package's, and its end metrics.

The same numpy inputs (made from a seed) go through the JAX functions of
`research/qtopt/networks.py` on flax variables and the port's on the
converted state. Batch-norm statistics and affine params are perturbed
away from their init so the folded scales are exercised.

Tolerances:
  * the quantizers' int8 tensors: bit for bit (half-to-even rounding,
    clip at ±127), values exactly on .5 after the division included;
  * `eff_scale`, `shift`, `scales_from_stats` and `calibration_stats`:
    1e-6 relative (one f32 operation order); in bf16 the calibration's
    max-abs values within one bf16 step (2^-7 relative);
  * `quantized_encode`, `quantized_score_population` and
    `quantized_pool_population` in f32: 1e-5 absolute (the same f32
    arithmetic in other conv and GEMM summation orders). bf16: 2e-2
    absolute on values below 2.5, the earlier bf16 parity tests' bound
    (one bf16 step there is at most 2^-6; a value that rounds to the other
    neighbour in one framework moves by one step, and its int8 code
    downstream by one);
  * the learner's four `_cem_fns` paths with JAX's CEM noise injected, f32
    model: actions and best scores within 1e-5;
  * the JAX package's end-metric gates (`tests/test_mfu_levers.py`) on the
    port's int8 against the port's bf16 tower: score error / spread and
    value regret / spread < 0.05, Bellman targets within 5e-3.
"""

import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.research.qtopt import networks as jax_net  # noqa: E402
from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    GraspingQModel as JaxModel,
    QTOptLearner as JaxLearner,
)
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import networks  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    GraspingQModel,
    QTOptLearner,
    ReplayBuffer,
    qtopt_learner,
    train_qtopt,
)
from tensor2robot_tpu_torch.specs import make_random_tensors  # noqa: E402

_TINY = dict(image_size=16, torso_filters=(8, 8), head_filters=(8, 8),
             dense_sizes=(16,), action_dim=3,
             extra_state_features={"height": (1,)})
_CEM = dict(cem_population=16, cem_iterations=2, cem_elites=4)
_B, _P = 6, 16


def _perturbed_variables(jax_model, seed=0):
  state = jax_model.create_inference_state(jax.random.PRNGKey(seed))
  rng = np.random.default_rng(seed)
  params = jax.tree_util.tree_map(np.asarray, state.params)
  stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
  for name in params:
    if "_bn_" in name:
      shape = params[name]["scale"].shape
      params[name]["scale"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
      params[name]["bias"] = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
      stats[name]["mean"] = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
      stats[name]["var"] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
  variables = {"params": params}
  if stats:
    variables["batch_stats"] = stats
  return variables


def _features(kwargs, batch, seed):
  rng = np.random.default_rng(seed)
  size, a_dim = kwargs["image_size"], kwargs["action_dim"]
  feats = {"image": rng.integers(0, 256, (batch, size, size, 3),
                                 dtype=np.uint8),
           "action": rng.uniform(-1, 1, (batch, a_dim)).astype(np.float32)}
  for key, shape in kwargs.get("extra_state_features", {}).items():
    feats[key] = rng.standard_normal((batch,) + shape).astype(np.float32)
  return feats


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


class _Pair:
  """A JAX network + variables and the port's bound network on the
  converted state, at one dtype, calibrated on the same batch."""

  def __init__(self, kwargs, jdt, tdt, seed=0):
    self.jax_model = JaxModel(device_dtype=jdt, **kwargs)
    self.model = GraspingQModel(device_dtype=tdt, **kwargs)
    self.variables = _perturbed_variables(self.jax_model, seed)
    self.state = convert.convert_variables(self.variables)
    self.net = self.model.bind(self.state)
    self.jnet = self.jax_model.network
    feats = _features(kwargs, _B, seed + 1)
    self.feats = feats
    self.extras = {k: v for k, v in feats.items()
                   if k not in ("image", "action")}
    self.actions = np.random.default_rng(seed + 2).uniform(
        -1, 1, (_B, _P, kwargs["action_dim"])).astype(np.float32)
    self.jax_stats = jax.device_get(jax.jit(functools.partial(
        self.jnet.apply, method="calibration_stats"))(self.variables, feats))
    with torch.no_grad():
      self.stats = self.net.calibration_stats(
          {k: torch.from_numpy(v) for k, v in feats.items()})
    self.scales = jax_net.scales_from_stats(self.jax_stats)
    self.jax_tower = jax_net.quantize_tower(self.jnet, self.variables,
                                            self.scales)
    with torch.no_grad():
      self.tower = networks.quantize_tower(self.net, self.scales)

  def torch_extras(self):
    return {k: torch.from_numpy(v) for k, v in self.extras.items()}


@functools.lru_cache(maxsize=None)
def _pair(dtype):
  jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
  return _Pair(_TINY, jdt, tdt)


# ---- the quantizers, bit for bit ----


def test_quantize_weight_bit_for_bit():
  rng = np.random.default_rng(0)
  w = (rng.standard_normal((3, 3, 5, 7)) * rng.uniform(
      0.01, 3.0, 7)).astype(np.float32)              # HWIO, as flax keeps it
  w[..., 3] = 0.0                                    # an all-zero channel
  want_q, want_s = jax_net._quantize_weight(jnp.asarray(w))
  got_q, got_s = networks._quantize_weight(
      torch.from_numpy(w).permute(3, 2, 0, 1))       # the port's OIHW
  assert got_q.dtype == torch.int8
  np.testing.assert_array_equal(got_q.permute(2, 3, 1, 0).numpy(),
                                np.asarray(want_q))
  np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quantize_act_bit_for_bit_with_exact_halves():
  """Values that sit exactly on .5 after the division round half to
  even (2.5 → 2, 3.5 → 4, −2.5 → −2), and ±127 clips."""
  scale = 0.25  # a power of two: k.5 · scale divides back exactly
  halves = np.array([0.5, 1.5, 2.5, 3.5, -0.5, -2.5, -3.5, 126.5, -126.5,
                     127.5, 300.0, -300.0], np.float32) * scale
  rng = np.random.default_rng(1)
  x = np.concatenate([halves, rng.standard_normal(4096).astype(np.float32)
                      * 20.0])
  for s in (scale, 0.0123456, 1e-8):
    want = jax_net._quantize_act(jnp.asarray(x), jnp.asarray(s, jnp.float32))
    got = networks._quantize_act(torch.from_numpy(x),
                                 networks._scale_tensor(s, torch.device("cpu")))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  got = networks._quantize_act(torch.from_numpy(halves),
                               torch.tensor(scale))
  np.testing.assert_array_equal(
      got.numpy(), [0, 2, 2, 4, 0, -2, -4, 126, -126, 127, 127, -127])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tower_weights_and_scales(dtype):
  """The tower's int8 kernels bit for bit; `eff_scale` and `shift` from
  the same scales within 1e-6 relative. The calibration and
  `scales_from_stats` within 1e-6 relative in f32; in bf16 a max-abs of
  bf16 activations may sit one bf16 step (2^-7 relative) apart, when the
  largest activation rounds to the other neighbour in one framework."""
  pair = _pair(dtype)
  assert sorted(pair.stats) == sorted(pair.jax_stats) == [
      "head_in_1", "torso_in_0", "torso_in_1"]
  rtol = 1e-6 if dtype == "f32" else 2 ** -7
  for key, want in pair.jax_stats.items():
    np.testing.assert_allclose(pair.stats[key].item(), float(want),
                               rtol=rtol)
  port_scales = networks.scales_from_stats(
      {k: v.item() for k, v in pair.stats.items()})
  for key, want in pair.scales.items():
    np.testing.assert_allclose(port_scales[key], want, rtol=rtol)
  for part in ("torso", "head"):
    assert len(pair.tower[part]) == len(pair.jax_tower[part])
    for got, want in zip(pair.tower[part], pair.jax_tower[part]):
      np.testing.assert_array_equal(got["w_q"].permute(2, 3, 1, 0).numpy(),
                                    np.asarray(want["w_q"]))
      for key in ("eff_scale", "shift", "act_scale"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=1e-6,
                                   atol=0)


def test_tower_without_batch_norm_uses_conv_bias():
  kwargs = dict(_TINY, use_batch_norm=False)
  pair = _Pair(kwargs, jnp.float32, torch.float32, seed=3)
  for part in ("torso", "head"):
    for got, want in zip(pair.tower[part], pair.jax_tower[part]):
      np.testing.assert_array_equal(got["w_q"].permute(2, 3, 1, 0).numpy(),
                                    np.asarray(want["w_q"]))
      np.testing.assert_allclose(_np(got["shift"]), _np(want["shift"]),
                                 rtol=1e-6)
  _assert_tower_outputs(pair, atol=1e-5)


def _jax_outputs(pair):
  enc = jax_net.quantized_encode(pair.jnet, pair.jax_tower,
                                 jnp.asarray(pair.feats["image"]))
  args = (pair.jnet, pair.jax_tower, pair.variables, enc,
          {k: jnp.asarray(v) for k, v in pair.extras.items()},
          jnp.asarray(pair.actions))
  return {"encode": enc,
          "score": jax_net.quantized_score_population(*args),
          "pool": jax_net.quantized_pool_population(*args)}


def _port_outputs(pair):
  with torch.no_grad():
    enc = networks.quantized_encode(pair.net, pair.tower,
                                    torch.from_numpy(pair.feats["image"]))
    args = (pair.net, pair.tower, enc, pair.torch_extras(),
            torch.from_numpy(pair.actions))
    return {"encode": enc,
            "score": networks.quantized_score_population(*args),
            "pool": networks.quantized_pool_population(*args)}


def _assert_tower_outputs(pair, atol):
  want, got = _jax_outputs(pair), _port_outputs(pair)
  for key in want:
    assert tuple(got[key].shape) == tuple(want[key].shape), key
    np.testing.assert_allclose(_np(got[key]), _np(want[key]), atol=atol,
                               rtol=0, err_msg=key)
  return got


def test_tower_outputs_f32():
  got = _assert_tower_outputs(_pair("f32"), atol=1e-5)
  assert got["score"].dtype == torch.float32
  assert got["pool"].shape == (_P, _B, 8)


def test_tower_outputs_bf16():
  got = _assert_tower_outputs(_pair("bf16"), atol=2e-2)
  assert got["encode"].dtype == got["pool"].dtype == torch.bfloat16
  assert float(np.abs(_np(got["score"])).max()) < 2.5


def test_quantization_points_along_the_path_f32():
  """Each quantization point's int8 codes along both packages' own
  forwards: the torso's bit for bit (its inputs are exact in f32: the
  image over 255, then int8 convs summed exactly); the merged tensor's
  within one code, since the merge's f32 GEMM sums in another order."""
  pair = _pair("f32")
  image = pair.feats["image"]
  x_j = jnp.asarray(image).astype(jnp.float32) / jnp.asarray(255.0)
  with torch.no_grad():
    x_t = torch.from_numpy(image).float() / torch.tensor(255.0)
    for i, (lt, lj) in enumerate(zip(pair.tower["torso"],
                                     pair.jax_tower["torso"])):
      q_j = jax_net._quantize_act(x_j, lj["act_scale"])
      q_t = networks._quantize_act(x_t, lt["act_scale"])
      np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j),
                                    err_msg=f"torso_in_{i}")
      x_j = jax_net._int8_conv(x_j, lj, (2, 2), jnp.float32)
      x_t = networks._int8_conv(x_t, lt, 2, torch.float32)


# ---- the learner's four paths, against JAX with its noise injected ----


def _jax_noise(rng, iterations, shape):
  keys = jax.random.split(rng, iterations)
  return torch.from_numpy(np.stack(
      [np.asarray(jax.random.normal(k, shape)) for k in keys]))


@functools.lru_cache(maxsize=None)
def _learner_pair(cem_inference, cem_select):
  kwargs = dict(_TINY)
  jax_learner = JaxLearner(JaxModel(device_dtype=jnp.float32, **kwargs),
                           cem_inference=cem_inference,
                           cem_select=cem_select, **_CEM)
  learner = QTOptLearner(GraspingQModel(device_dtype=torch.float32, **kwargs),
                         cem_inference=cem_inference, cem_select=cem_select,
                         device="cpu", **_CEM)
  return jax_learner, learner


@pytest.mark.parametrize("cem_inference", ["bf16", "int8"])
@pytest.mark.parametrize("cem_select", ["lax", "fused"])
def test_cem_paths_match_jax(cem_inference, cem_select):
  jax_learner, learner = _learner_pair(cem_inference, cem_select)
  pair = _pair("f32")
  jax_state = pair.jax_model.create_inference_state(jax.random.PRNGKey(0))
  jax_state = jax_state.replace(params=pair.variables["params"],
                                batch_stats=pair.variables["batch_stats"])
  calib = {k: v for k, v in pair.feats.items()}
  if cem_inference == "int8":
    jax_learner.calibrate(jax_state, calib)
    learner.calibrate(pair.state, calib)
    for key, want in jax_learner._act_scales.items():
      np.testing.assert_allclose(learner.act_scales[key], want, rtol=1e-6)
  obs = {k: v for k, v in pair.feats.items() if k != "action"}
  rng = jax.random.PRNGKey(7)
  want = np.asarray(jax_learner.build_policy()(
      jax_state, {k: jnp.asarray(v) for k, v in obs.items()}, rng))
  noise = _jax_noise(rng, 2, (_B, _CEM["cem_population"], 3))
  got = learner.build_policy()(pair.state, obs, noise=noise)
  np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---- the end-metric gates of tests/test_mfu_levers.py, in the port ----


def _gate_learner(cem_inference="bf16", cem_select="lax"):
  model = GraspingQModel(image_size=16, torso_filters=(8, 8),
                         head_filters=(8, 8), dense_sizes=(16,), action_dim=3,
                         device_dtype=torch.float32)
  return QTOptLearner(model, cem_population=16, cem_iterations=2,
                      cem_elites=4, cem_inference=cem_inference,
                      cem_select=cem_select, device="cpu")


def _gate_batch(learner, batch_size=8, seed=0):
  flat = make_random_tensors(learner.transition_specification(),
                             batch_size=batch_size, seed=seed).to_flat_dict()
  return {k: torch.from_numpy(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def gate_pair():
  base = _gate_learner()
  i8 = _gate_learner(cem_inference="int8")
  state = base.create_state(seed=0)
  tr = _gate_batch(base)
  i8.calibrate(state, tr)
  return base, i8, state, tr


def _gen(seed):
  return torch.Generator().manual_seed(seed)


def test_gate_score_parity(gate_pair):
  base, i8, state, tr = gate_pair
  feats = {k: v for k, v in tr.items()
           if not k.startswith("next_") and k not in ("reward", "done")}
  actions = torch.from_numpy(np.random.default_rng(3).uniform(
      -1, 1, (8, 16, 3)).astype(np.float32))
  network = base.model.bind(state.train_state)
  with torch.no_grad():
    exact = base._cem_fns(network, feats)[0](actions)
    quant = i8._cem_fns(network, feats)[0](actions)
  err = (exact - quant).abs().max().item()
  spread = (exact.max() - exact.min()).item() + 1e-6
  assert err / spread < 0.05, (err, spread)


def test_gate_action_value_regret(gate_pair):
  base, i8, state, _ = gate_pair
  obs = make_random_tensors(base.observation_specification(), batch_size=8,
                            seed=1).to_flat_dict()
  a_exact = base.build_policy()(state, obs, generator=_gen(7))
  a_quant = i8.build_policy()(state, obs, generator=_gen(7))
  obs_t = {k: torch.from_numpy(v) for k, v in obs.items()}
  with torch.no_grad():
    score_fn = base._cem_fns(base.model.bind(state.train_state), obs_t)[0]
    q_exact = score_fn(a_exact[:, None])[:, 0]
    q_quant = score_fn(a_quant[:, None])[:, 0]
  regret = (q_exact - q_quant).max().item()
  spread = (q_exact.max() - q_exact.min()).item() + 1e-6
  assert regret / spread < 0.05, (regret, spread)


def test_gate_bellman_target_parity(gate_pair):
  base, i8, state, tr = gate_pair
  _, m_exact = base.train_step(state, tr, generator=_gen(1))
  _, m_quant = i8.train_step(state, tr, generator=_gen(1))
  for key in ("q_next_mean", "target_mean"):
    np.testing.assert_allclose(m_quant[key].item(), m_exact[key].item(),
                               atol=5e-3)


def test_gate_needs_calibration_contract():
  i8 = _gate_learner(cem_inference="int8")
  state = i8.create_state(seed=0)
  assert i8.needs_calibration and i8.cem_inference == "int8"
  with pytest.raises(RuntimeError, match="calibrate"):
    i8.train_step(state, _gate_batch(i8), generator=_gen(1))
  with pytest.raises(RuntimeError, match="calibrate"):
    i8.build_policy()(state, make_random_tensors(
        i8.observation_specification(), batch_size=2, seed=0).to_flat_dict(),
        generator=_gen(1))
  i8.ensure_calibrated(state.train_state)
  assert not i8.needs_calibration
  i8.train_step(state, _gate_batch(i8), generator=_gen(1))
  assert not _gate_learner().needs_calibration  # bf16 never needs it


def test_ensure_calibrated_matches_jax_spec_random_batch():
  """`ensure_calibrated` calibrates on the spec-random batch of 16 at
  seed 0, the JAX learner's: the same scales on converted weights."""
  pair = _pair("f32")
  jax_learner, learner = _learner_pair("int8", "lax")
  jax_state = pair.jax_model.create_inference_state(jax.random.PRNGKey(0))
  jax_state = jax_state.replace(params=pair.variables["params"],
                                batch_stats=pair.variables["batch_stats"])
  jax_learner._act_scales = None
  learner._act_scales = None
  jax_learner.ensure_calibrated(jax_state)
  learner.ensure_calibrated(pair.state)
  for key, want in jax_learner._act_scales.items():
    np.testing.assert_allclose(learner.act_scales[key], want, rtol=1e-6)


def test_recalibration_keeps_captured_scales_and_warns(monkeypatch):
  """A graph keeps the scale tensors it was captured over (they are never
  overwritten), eager calls read the new ones, and recalibrating after a
  capture read the scales warns."""
  i8 = _gate_learner(cem_inference="int8")
  state = i8.create_state(seed=0)
  tr = _gate_batch(i8)
  i8.calibrate(state, tr)
  cpu = torch.device("cpu")
  monkeypatch.setattr(qtopt_learner, "_capturing", lambda device: True)
  captured = i8._act_scale_tensors(cpu)
  kept = {k: v.clone() for k, v in captured.items()}
  monkeypatch.setattr(qtopt_learner, "_capturing", lambda device: False)
  other = _gate_batch(i8, seed=5)
  other["image"] = other["image"] // 2
  with pytest.warns(RuntimeWarning, match="captured"):
    i8.calibrate(state, other)
  fresh = i8._act_scale_tensors(cpu)
  for key in captured:
    assert torch.equal(captured[key], kept[key])  # never overwritten
    assert fresh[key] is not captured[key]
  assert fresh["torso_in_0"].item() != kept["torso_in_0"].item()
  with warnings.catch_warnings():
    warnings.simplefilter("error")
    i8.calibrate(state, tr)  # nothing captured since: silent


def test_train_qtopt_calibrates_before_its_first_step(tmp_path):
  learner = _gate_learner(cem_inference="int8", cem_select="fused")
  replay = ReplayBuffer(learner.transition_specification(), capacity=64,
                        seed=0)
  replay.add(make_random_tensors(learner.transition_specification(),
                                 batch_size=32, seed=1).to_flat_dict())
  order = []
  calibrate, train_step = learner.calibrate, learner.train_step

  def record_calibrate(state, features):
    order.append(("calibrate", sorted(features.to_flat_dict()
                                      if hasattr(features, "to_flat_dict")
                                      else features)))
    return calibrate(state, features)

  def record_step(*args, **kwargs):
    order.append(("step",))
    return train_step(*args, **kwargs)

  learner.calibrate = record_calibrate
  learner.train_step = record_step
  state = train_qtopt(learner, str(tmp_path), replay_buffer=replay,
                      max_train_steps=2, batch_size=8, log_every_steps=2,
                      save_checkpoints_steps=2, steps_per_dispatch=2)
  assert state.step == 2
  assert order[0][0] == "calibrate" and "next_image" in order[0][1]
  assert [o[0] for o in order[1:]] == ["step", "step"]
  assert not learner.needs_calibration
