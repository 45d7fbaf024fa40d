"""QT-Opt learner (port of `research/qtopt/qtopt_learner.py`).

One Bellman update per `train_step` (eagerly, or K of them captured as
one CUDA graph by `train_qtopt`):
  1. CEM-maximize Q_target(s', ·) for the whole batch, under no_grad
     (the target network is the Polyak-averaged params with the ONLINE
     batch statistics, in eval mode);
  2. target = r + γ (1 − done) max_a' Q_target(s', a'), clipped to
     [0, 1] for the sigmoid grasp-success head;
  3. the critic's sigmoid cross-entropy update on Q(s, a) with Adam;
  4. the Polyak target update old + τ·(new − old), params only.
The acting half (`_cem_fns`, `build_policy`) is the same CEM, on the
online params. CEM noise comes from a `torch.Generator` or whole as
`noise` `[iterations, B, P, A]` (a test can inject JAX's draw).

Not ported: data-parallel steps (`axis_name`, ROADMAP A11) and the int8
tower (`cem_inference="int8"`, A5); both raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.device import resolve_device
from tensor2robot_tpu_torch.models.abstract_model import Metrics, TrainState
from tensor2robot_tpu_torch.ops import fused_cem_select
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.research.qtopt import networks as net_lib
from tensor2robot_tpu_torch.research.qtopt.t2r_models import GraspingQModel
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct
from tensor2robot_tpu_torch.utils import tree


def _polyak(tau: float, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
  """`old + tau·(new − old)`, the JAX package's contraction-stable form
  (not `torch.lerp`, which switches formula at weight 0.5). Where XLA
  contracts the multiply-add into an FMA the two may differ by 1 ulp."""
  return old + tau * (new - old)


@dataclasses.dataclass(frozen=True, eq=False)
class QTOptState:
  """Learner state: critic TrainState + target network params."""

  train_state: TrainState
  target_params: Any

  @property
  def step(self) -> int:
    return self.train_state.step

  def to(self, device) -> "QTOptState":
    return QTOptState(
        train_state=self.train_state.to(device),
        target_params={k: v.to(device)
                       for k, v in self.target_params.items()})


def _state_device(ts: TrainState) -> torch.device:
  return next(iter(ts.params.values())).device


def _split_transitions(transitions):
  """(online features, next-state features, flat) of a transition batch."""
  flat = dict(transitions.to_flat_dict()
              if hasattr(transitions, "to_flat_dict") else transitions)
  features = {k: v for k, v in flat.items()
              if not k.startswith("next_") and k not in ("reward", "done")}
  next_features = {k[len("next_"):]: v for k, v in flat.items()
                   if k.startswith("next_")}
  return features, next_features, flat


class QTOptLearner:
  """QT-Opt over a GraspingQModel: Bellman training and its CEM policy."""

  def __init__(self,
               model: GraspingQModel,
               gamma: float = 0.9,
               cem_iterations: int = 2,
               cem_population: int = 64,
               cem_elites: int = 6,
               action_low: float = -1.0,
               action_high: float = 1.0,
               target_update_tau: float = 0.05,
               clip_targets: Optional[Tuple[float, float]] = (0.0, 1.0),
               cem_inference: str = "bf16",
               cem_select: str = "lax",
               device=None):
    """The JAX constructor's arguments, plus `device` (None = CUDA),
    where `create_state` puts the state.

    cem_select: "lax" (sort + gather, the reference path) or "fused"
    (scoring + top-E + elite stats in the `ops.fused_cem_select` kernel
    through `cem_maximize`'s select_fn seam). `clip_targets` applies
    only with the model's `sigmoid_q`."""
    if cem_inference not in ("bf16", "int8"):
      raise ValueError(f"cem_inference={cem_inference!r} not in "
                       "('bf16', 'int8')")
    if cem_select not in ("lax", "fused"):
      raise ValueError(f"cem_select={cem_select!r} not in "
                       "('lax', 'fused')")
    if cem_inference == "int8":
      raise NotImplementedError(
          "cem_inference='int8' (the quantized CEM tower) is not ported "
          "yet; see ROADMAP.md Queue A, item A5.")
    self._model = model
    self._gamma = gamma
    self._cem_iterations = cem_iterations
    self._cem_population = cem_population
    self._cem_elites = cem_elites
    self._action_low = action_low
    self._action_high = action_high
    self._tau = target_update_tau
    self._clip_targets = clip_targets if model.sigmoid_q else None
    self._cem_inference = cem_inference
    self._cem_select = cem_select
    self._device = resolve_device(device)
    self._target_network = None

  @property
  def model(self) -> GraspingQModel:
    return self._model

  @property
  def device(self) -> torch.device:
    return self._device

  @property
  def cem_population(self) -> int:
    return self._cem_population

  @property
  def cem_iterations(self) -> int:
    return self._cem_iterations

  @property
  def cem_inference(self) -> str:
    return self._cem_inference

  def create_state(self, seed: int = 0) -> QTOptState:
    """Params, batch stats and Adam state from `seed`; the target is a
    distinct copy of the params."""
    train_state = self._model.create_train_state(seed, self._device)
    target = {k: v.clone() for k, v in train_state.params.items()}
    return QTOptState(train_state=train_state, target_params=target)

  def _cem_fns(self, network, state_features):
    """(score_fn, select_fn) for `cem_maximize` — exactly one is used.

    Both run the torso ONCE per state; "fused" routes the scoring tail
    through `ops.fused_cem_select` via the select seam (the kernel
    applies the sigmoid of a `sigmoid_q` model itself).
    """
    if self._cem_select == "lax":
      return cem.make_encoded_q_score_fn(network, state_features), None
    flat_state = dict(state_features.to_flat_dict()
                      if hasattr(state_features, "to_flat_dict")
                      else state_features)
    image = flat_state.pop("image")
    extras = {k: v for k, v in flat_state.items() if k != "action"}
    encoded = network.encode(image)
    dense = net_lib.q_head_dense_params(network, dtype=network.dtype)
    sigmoid = self._model.sigmoid_q

    def select_fn(actions, min_std):
      return fused_cem_select(
          network.pool_population(encoded, extras, actions), actions,
          dense, num_elites=self._cem_elites, min_std=min_std,
          sigmoid=sigmoid)

    return None, select_fn

  def _cem(self, score_fn, select_fn, batch, generator, noise, device,
           population=None, iterations=None):
    return cem.cem_maximize(
        score_fn, batch, self._model.action_dim,
        iterations=iterations or self._cem_iterations,
        population=population or self._cem_population,
        num_elites=self._cem_elites,
        low=self._action_low, high=self._action_high,
        select_fn=select_fn, generator=generator, noise=noise,
        device=device)

  # ---- target computation ----

  def _target_network_over(self, target_params, batch_stats):
    """The eval-mode network over the target params and the online
    batch statistics: one meta-device module, its tensors re-assigned
    each step (nothing copied). Under a CUDA-graph capture this runs
    once per captured step, on the host: the first step of a dispatch
    points the module at the graph's static target buffers, a later one
    at the Polyak output of the step before it in the graph's pool; a
    replay reads those addresses and reassigns nothing."""
    if self._target_network is None:
      with torch.device("meta"):
        self._target_network = self._model.create_network()
      self._target_network.eval()
    self._target_network.load_state_dict(
        {**target_params, **batch_stats}, strict=True, assign=True)
    return self._target_network

  def _target_q_values(self, target_params, batch_stats, next_features,
                       generator=None, noise=None) -> torch.Tensor:
    """max_a' Q_target(s', a') by CEM: its best score, on the sigmoid
    scale when the model has `sigmoid_q`. No gradient flows."""
    batch = tree.leaves(next_features)[0].shape[0]
    device = next(iter(target_params.values())).device
    with torch.no_grad():
      network = self._target_network_over(target_params, batch_stats)
      score_fn, select_fn = self._cem_fns(network, next_features)
      if score_fn is not None and self._model.sigmoid_q:
        q_fn = score_fn
        score_fn = lambda actions: torch.sigmoid(q_fn(actions))  # noqa: E731
      return self._cem(score_fn, select_fn, batch, generator, noise,
                       device).best_score

  # ---- the train step ----

  def train_step(self, state: QTOptState, transitions,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 axis_name: Optional[str] = None
                 ) -> Tuple[QTOptState, Metrics]:
    """One Bellman update on a batch of transitions (a struct or flat
    dict of tensors on the state's device): image, action [A], reward
    [1], done [1], next_image (+ any extra state features and their
    next_ twins). Returns the new state (the old one is untouched) and
    the metrics `loss`, `grad_norm`, `q_loss`, `q_mean`,
    `target_q_mean`, `q_next_mean` and `target_mean`."""
    grads, new_stats, metrics = self.train_grads(
        state, transitions, generator=generator, noise=noise,
        axis_name=axis_name)
    return self.apply_gradients(state, grads, new_stats), metrics

  def train_grads(self, state: QTOptState, transitions,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  axis_name: Optional[str] = None
                  ) -> Tuple[Dict[str, torch.Tensor], Dict, Metrics]:
    """CEM Bellman targets + critic gradients, no optimizer update:
    (grads, new batch stats, metrics)."""
    if axis_name is not None:
      raise NotImplementedError(
          f"axis_name={axis_name!r}: data-parallel steps are not ported "
          "yet (ROADMAP A11).")
    features, next_features, flat = _split_transitions(transitions)
    ts = state.train_state
    q_next = self._target_q_values(state.target_params, ts.batch_stats,
                                   next_features, generator, noise)
    reward = flat["reward"].reshape(-1).float()
    done = flat["done"].reshape(-1).float()
    target = reward + self._gamma * (1.0 - done) * q_next
    if self._clip_targets is not None:
      target = torch.clamp(target, *self._clip_targets)
    target = target.detach()
    grads, new_stats, metrics = self._model.train_grads(
        ts, features, {"target_q": target[:, None]})
    metrics["q_next_mean"] = torch.mean(q_next)
    metrics["target_mean"] = torch.mean(target)
    return grads, new_stats, metrics

  def apply_gradients(self, state: QTOptState, grads, new_stats
                      ) -> QTOptState:
    """The critic's optimizer step + the Polyak target sync."""
    new_ts = self._model.apply_gradients(state.train_state, grads,
                                         new_stats)
    new_target = {k: _polyak(self._tau, new_ts.params[k], old)
                  for k, old in state.target_params.items()}
    return QTOptState(train_state=new_ts, target_params=new_target)

  # ---- on-robot / actor policy ----

  def build_policy(self, cem_population: Optional[int] = None,
                   cem_iterations: Optional[int] = None):
    """Returns (state, observations, generator=None, noise=None) →
    best actions [B, A] (f32, on the state's device).

    `state` is a `QTOptState` or a bare critic `TrainState` (acting
    reads only the online params). Observations are a struct/dict of
    tensors or numpy arrays with a leading batch dim; numpy leaves are
    moved to the state's device. Noise comes from `generator` (on that
    device) or is given whole as `noise` `[iterations, B, P, A]`.
    """

    def policy(state, observations, generator=None, noise=None):
      ts = state.train_state if isinstance(state, QTOptState) else state
      device = _state_device(ts)
      obs = tree.map_structure(
          lambda x: torch.as_tensor(x, device=device), observations)
      batch = tree.leaves(obs)[0].shape[0]
      with torch.inference_mode():
        result = self._cem(*self._cem_fns(self._model.bind(ts), obs), batch,
                           generator, noise, device,
                           population=cem_population,
                           iterations=cem_iterations)
      return result.best_action

    return policy

  def observation_specification(self) -> TensorSpecStruct:
    """Serving-side observation spec: the model's TRAIN feature spec
    minus the `action` CEM optimizes over."""
    feat = self._model.get_feature_specification(Mode.TRAIN).to_flat_dict()
    return TensorSpecStruct.from_flat_dict(
        {k: v for k, v in feat.items() if k != "action"})

  def transition_specification(self) -> TensorSpecStruct:
    """The replay-buffer transition spec, derived from the model specs:
    the TRAIN features, their next_ twins but the action, reward and
    done [1] f32."""
    model_feat = self._model.get_feature_specification(
        Mode.TRAIN).to_flat_dict()
    out = dict(model_feat)
    for key, spec in model_feat.items():
      if key != "action":
        out[f"next_{key}"] = spec.replace(name=f"next_{spec.name or key}")
    out["reward"] = ExtendedTensorSpec(shape=(1,), dtype=np.float32,
                                       name="reward")
    out["done"] = ExtendedTensorSpec(shape=(1,), dtype=np.float32,
                                     name="done")
    return TensorSpecStruct.from_flat_dict(out)
