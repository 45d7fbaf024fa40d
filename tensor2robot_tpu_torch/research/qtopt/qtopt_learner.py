"""QT-Opt learner, acting half (port of `research/qtopt/qtopt_learner.py`).

This slice ports what serving needs: the constructor's checks, state
creation, the CEM scoring/selection construction (`_cem_fns`) for the
bf16/f32 tower under both `cem_select` modes, `build_policy` and the
observation spec. The Bellman update (targets, critic loss, Adam,
Polyak) and the int8 tower come in later slices (ROADMAP A4, A5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.device import resolve_device
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.ops import fused_cem_select
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.research.qtopt import networks as net_lib
from tensor2robot_tpu_torch.research.qtopt.t2r_models import GraspingQModel
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.utils import tree


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


class QTOptLearner:
  """QT-Opt over a GraspingQModel; this slice builds its CEM policy."""

  def __init__(self,
               model: GraspingQModel,
               cem_iterations: int = 2,
               cem_population: int = 64,
               cem_elites: int = 6,
               action_low: float = -1.0,
               action_high: float = 1.0,
               cem_inference: str = "bf16",
               cem_select: str = "lax",
               device=None):
    """The training arguments of the JAX constructor (gamma, target
    update, target clipping) come with the training slice.

    cem_select: "lax" (sort + gather, the reference path) or "fused"
    (scoring + top-E + elite stats in the `ops.fused_cem_select` kernel
    through `cem_maximize`'s select_fn seam). `device` (None = CUDA)
    is where `create_state` puts the parameters."""
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
    self._cem_iterations = cem_iterations
    self._cem_population = cem_population
    self._cem_elites = cem_elites
    self._action_low = action_low
    self._action_high = action_high
    self._cem_inference = cem_inference
    self._cem_select = cem_select
    self._device = resolve_device(device)

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
    train_state = self._model.create_inference_state(seed, self._device)
    target = {k: v.clone() for k, v in train_state.params.items()}
    return QTOptState(train_state=train_state, target_params=target)

  def _cem_fns(self, network, state_features):
    """(score_fn, select_fn) for `cem_maximize` — exactly one is used.

    Both run the torso ONCE per state; "fused" routes the scoring tail
    through `ops.fused_cem_select` via the select seam.
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
    population = cem_population or self._cem_population
    iterations = cem_iterations or self._cem_iterations

    def policy(state, observations, generator=None, noise=None):
      ts = state.train_state if isinstance(state, QTOptState) else state
      device = _state_device(ts)
      obs = tree.map_structure(
          lambda x: torch.as_tensor(x, device=device), observations)
      batch = tree.leaves(obs)[0].shape[0]
      with torch.inference_mode():
        score_fn, select_fn = self._cem_fns(self._model.bind(ts), obs)
        result = cem.cem_maximize(
            score_fn, batch, self._model.action_dim,
            iterations=iterations, population=population,
            num_elites=self._cem_elites,
            low=self._action_low, high=self._action_high,
            select_fn=select_fn, generator=generator, noise=noise,
            device=device)
      return result.best_action

    return policy

  def observation_specification(self) -> TensorSpecStruct:
    """Serving-side observation spec: the model's TRAIN feature spec
    minus the `action` CEM optimizes over."""
    feat = self._model.get_feature_specification(Mode.TRAIN).to_flat_dict()
    return TensorSpecStruct.from_flat_dict(
        {k: v for k, v in feat.items() if k != "action"})
