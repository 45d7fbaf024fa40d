"""The model-side modules of the last slice against the JAX package, on
the CPU: `ClassificationModel` / `MockClassificationModel`, dropout
(`layers.core`), every `remat_policy`, and QT-Opt over a critic without
the encode/head split (`cem.make_q_score_fn`).

  * Classification: logits within 1e-5 of JAX's from the same converted
    params, equal loss and accuracy (integer labels, ties to the lower
    class); the train step's loss and gradients within 1e-5.
  * Dropout: with JAX's masks injected into both (torch's streams cannot
    match threefry, ROADMAP trap 5) a train step's loss and gradients
    equal JAX's within 1e-5; the keep rate over many draws is 1 − p;
    eval mode is the identity; a train-mode draw outside a generator
    raises.
  * `remat_policy` "full", "dots" and "dots_no_batch" give the gradients
    and metrics of "none" bit for bit, dropout and a distorting image
    preprocessor included (the draws are saved, not redrawn); an unknown
    policy raises JAX's ValueError.
  * A Bellman step of `QTOptLearner` over `MockCriticModel` (a tiled
    population through the plain critic, the lax select) equals JAX's
    with JAX's CEM noise injected.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen.stochastic as flax_stochastic  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu import specs as jax_specs  # noqa: E402
from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    QTOptLearner as JaxLearner,
)
from tensor2robot_tpu.utils import mocks as jax_mocks  # noqa: E402
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode  # noqa: E402
from tensor2robot_tpu_torch.layers import core  # noqa: E402
from tensor2robot_tpu_torch.models import TrainState, convert  # noqa: E402
from tensor2robot_tpu_torch.models import optimizers  # noqa: E402
from tensor2robot_tpu_torch.preprocessors import ImagePreprocessor  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import QTOptLearner  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt.qtopt_learner import (  # noqa: E402
    QTOptState,
)
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    VRGripperTransformerModel,
)
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec  # noqa: E402
from tensor2robot_tpu_torch.specs import TensorSpecStruct  # noqa: E402
from tensor2robot_tpu_torch.utils import mocks  # noqa: E402

torch.set_num_threads(1)

_B = 16


def _batch(seed=0, classes=3):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((_B, 4)).astype(np.float32)
  label = rng.integers(0, classes, (_B, 1)).astype(np.int64)
  return {"x": x}, {"label": label}


def _torch(d):
  return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def _jax_model(dropout_rate):
  model = jax_mocks.MockClassificationModel(dropout_rate=dropout_rate,
                                            hidden_sizes=(16, 8))
  state = jax.jit(functools.partial(model.create_train_state,
                                    batch_size=2))(jax.random.PRNGKey(0))
  return model, state


def _port(dropout_rate, jax_state, **kwargs):
  model = mocks.MockClassificationModel(dropout_rate=dropout_rate,
                                        hidden_sizes=(16, 8), **kwargs)
  params = convert.convert_params(jax.device_get(jax_state.params))
  state = TrainState(step=0, params=params, batch_stats={},
                     opt_state=model.tx.init(params))
  return model, state


def test_classification_matches_jax():
  jax_model, jax_state = _jax_model(0.0)
  model, state = _port(0.0, jax_state)
  features, labels = _batch()
  logits = model.predict_step(state, _torch(features))["logits"]
  want = jax_model.predict_step(jax_state, jax_specs.TensorSpecStruct
                                .from_flat_dict(
                                    {"x": jnp.asarray(features["x"])}))
  np.testing.assert_allclose(logits.numpy(), np.asarray(want["logits"]),
                             rtol=1e-5, atol=1e-5)
  metrics = model.eval_step(state, _torch(features), _torch(labels))
  want = jax_model.eval_step(
      jax_state, {"x": jnp.asarray(features["x"])},
      {"label": jnp.asarray(labels["label"])})
  for key in ("loss", "cross_entropy", "accuracy"):
    np.testing.assert_allclose(float(metrics[key]), float(want[key]),
                               rtol=1e-5, err_msg=key)
  # The accuracy's ties go to the lower class, as jnp.argmax's.
  tied = torch.zeros(4, 3)
  _, scalars = model.model_train_fn(
      {}, {"label": torch.zeros(4, 1, dtype=torch.int64)},
      {"logits": tied}, Mode.TRAIN)
  assert float(scalars["accuracy"]) == 1.0


def _jax_masks(shapes, seed=3):
  """One keep mask per dropout layer (keep 1 − 0.25), seeded."""
  rng = np.random.default_rng(seed)
  return [rng.random(shape) < 0.75 for shape in shapes]


def test_dropout_train_step_matches_jax_with_injected_masks(monkeypatch):
  """JAX's `nn.Dropout` and the port's draw the same masks (patched in
  on both sides): the train step's loss, metrics and gradients agree."""
  jax_model, jax_state = _jax_model(0.25)
  model, state = _port(0.25, jax_state)
  features, labels = _batch(seed=1)
  masks = _jax_masks([(_B, 16), (_B, 8)])
  jax_masks = list(masks)
  monkeypatch.setattr(flax_stochastic.random, "bernoulli",
                      lambda key, p, shape: jnp.asarray(jax_masks.pop(0)))
  port_masks = list(masks)
  monkeypatch.setattr(core, "draw_keep", lambda shape, keep, device:
                      torch.from_numpy(port_masks.pop(0)))
  j_grads, _, j_metrics = jax_model.train_grads(
      jax_state, {"x": jnp.asarray(features["x"])},
      {"label": jnp.asarray(labels["label"])}, jax.random.PRNGKey(1))
  grads, _, metrics = model.train_grads(state, _torch(features),
                                        _torch(labels))
  assert not jax_masks and not port_masks
  for key in ("loss", "accuracy", "grad_norm"):
    np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]),
                               rtol=1e-5, err_msg=key)
  want = convert.convert_params(jax.device_get(j_grads))
  for key, g in grads.items():
    np.testing.assert_allclose(g.numpy(), want[key].numpy(), rtol=1e-5,
                               atol=1e-6, err_msg=key)


def test_dropout_keep_rate_eval_identity_and_the_explicit_generator():
  x = torch.ones(200_000)
  with core.random_stream(torch.Generator().manual_seed(0)):
    y = core.dropout(x, 0.3, train=True)
  kept = (y != 0).float().mean().item()
  assert abs(kept - 0.7) < 0.005
  np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.7, rtol=1e-6)
  assert core.dropout(x, 0.3, train=False) is x
  with pytest.raises(RuntimeError, match="explicit generator"):
    core.dropout(x, 0.3, train=True)
  # Two draws from one generator differ; reseeding repeats them.
  g = torch.Generator().manual_seed(5)
  with core.random_stream(g):
    a, b = (core.dropout(x[:64], 0.5, True) for _ in range(2))
  with core.random_stream(g.manual_seed(5)):
    c = core.dropout(x[:64], 0.5, True)
  assert not torch.equal(a, b) and torch.equal(a, c)


def _preprocessed_model(remat):
  """A VRGripper-free image model: the mock classifier over a distorting
  `ImagePreprocessor` crop of a 12 × 12 image, with dropout."""

  class _ImageClassifier(mocks.MockClassificationModel):

    def get_feature_specification(self, mode):
      st = TensorSpecStruct()
      st.image = ExtendedTensorSpec(shape=(8, 8, 3), dtype=np.float32,
                                    name="image")
      return st

  return _ImageClassifier(
      dropout_rate=0.3, hidden_sizes=(16, 8), remat_policy=remat,
      preprocessor_cls=functools.partial(ImagePreprocessor, src_height=12,
                                         src_width=12))


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_every_remat_policy_equals_none_bit_for_bit(policy):
  """Two steps each: the classifier with dropout, the image classifier
  (random crops and distortions, dropout) and the transformer; the same
  generator seed for both policies."""
  rng = np.random.default_rng(9)
  image = {"image": torch.from_numpy(rng.integers(
      0, 256, (_B, 12, 12, 3), dtype=np.uint8))}
  features, labels = _batch(seed=2)
  cases = [
      (lambda remat: mocks.MockClassificationModel(
          dropout_rate=0.3, hidden_sizes=(16, 8), remat_policy=remat),
       _torch(features), _torch(labels)),
      (_preprocessed_model, image, _torch(labels)),
  ]
  episodes = {"image": torch.from_numpy(rng.integers(
      0, 256, (2, 8, 16, 16, 3), dtype=np.uint8)),
              "gripper_pose": torch.from_numpy(rng.standard_normal(
                  (2, 8, 3)).astype(np.float32))}
  cases.append((lambda remat: VRGripperTransformerModel(
      image_size=16, filters=(4,), embedding_size=8, width=16, depth=1,
      num_heads=2, max_context_length=8, attention_impl="reference",
      device_dtype=torch.float32, remat_policy=remat), episodes,
                {"action": torch.from_numpy(rng.standard_normal(
                    (2, 8, 3)).astype(np.float32))}))
  for make, f, lab in cases:
    runs = []
    for remat in ("none", policy):
      model = make(remat)
      state = model.create_train_state(seed=0, device="cpu")
      model.generator("cpu").manual_seed(11)
      steps = []
      for _ in range(2):
        grads, stats, metrics = model.train_grads(state, f, lab)
        state = model.apply_gradients(state, grads, stats)
        steps.append((grads, metrics))
      runs.append(steps)
    for (g0, m0), (g1, m1) in zip(*runs):
      for key in g0:
        assert torch.equal(g0[key], g1[key]), key
      for key in m0:
        assert torch.equal(m0[key], m1[key]), key


def test_an_unknown_remat_policy_raises_jax_error():
  with pytest.raises(ValueError, match=r"not in \['none', 'dots', "
                     r"'dots_no_batch', 'full'\]"):
    mocks.MockClassificationModel(remat_policy="everything")


class _JaxCritic(jax_mocks.MockCriticModel):
  """JAX's mock critic with the action width its learner's CEM reads
  (the port's critics derive it from the spec)."""
  action_dim = 2


_CEM = dict(cem_population=8, cem_iterations=1, cem_elites=2)


def test_generic_critic_bellman_step_matches_jax():
  """`make_q_score_fn`: the state features tiled over the population,
  the candidates under "action", one critic call; the lax select."""
  jax_learner = JaxLearner(_JaxCritic(hidden_sizes=(16,)), **_CEM)
  jax_state = jax_learner.create_state(jax.random.PRNGKey(0), batch_size=2)
  port = QTOptLearner(mocks.MockCriticModel(hidden_sizes=(16,)),
                      device="cpu", **_CEM)
  assert port._model.action_dim == 2
  batch = jax_specs.make_random_tensors(
      jax_learner.transition_specification(), batch_size=8, seed=3)
  rng = jax.random.PRNGKey(4)
  j_grads, _, j_metrics = jax_learner.train_grads(
      jax_state, jax.tree_util.tree_map(jnp.asarray, batch), rng)
  key = jax.random.split(jax.random.split(rng)[0], 1)[0]
  noise = torch.from_numpy(np.array(
      jax.random.normal(key, (8, 8, 2)))[None])
  tree = lambda t: convert.convert_params(jax.device_get(t))  # noqa: E731
  ts = jax_state.train_state
  adam = ts.opt_state[0]
  state = QTOptState(
      train_state=TrainState(
          step=0, params=tree(ts.params), batch_stats={},
          opt_state=(optimizers.ScaleByAdamState(
              torch.tensor(int(adam.count), dtype=torch.int32),
              tree(adam.mu), tree(adam.nu)), optimizers.EmptyState())),
      target_params=tree(jax_state.target_params))
  grads, _, metrics = port.train_grads(
      state, {k: torch.from_numpy(np.array(v))
              for k, v in batch.to_flat_dict().items()}, noise=noise)
  for name in ("loss", "q_mean", "q_next_mean", "target_mean"):
    np.testing.assert_allclose(float(metrics[name]),
                               float(j_metrics[name]), rtol=1e-5,
                               atol=1e-6, err_msg=name)
  want = tree(j_grads)
  for name, g in grads.items():
    np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                               atol=1e-6, err_msg=name)
  assert JaxMode.TRAIN.value == Mode.TRAIN.value
