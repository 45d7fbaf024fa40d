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

The CEM's Q-tower runs in the network's compute dtype or as the int8
tower (`cem_inference="int8"`, `networks.quantize_tower`), and its
scoring tail as sort + gather or in the fused kernel (`cem_select`):
four paths. The int8 tower needs activation scales from `calibrate()`
(or `ensure_calibrated()`) before a step or policy runs.

Inside `parallel.collectives.data_parallel` over a learner group, a
step is one rank's shard of the global batch: batch norm normalizes with
the global batch's moments and the gradients and metrics are averaged
over the group before the optimizer step (the JAX mesh's implicit
all-reduce), so every rank applies the same update. Not ported:
pmap-style steps (`axis_name`, ROADMAP A11 rest) raise.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.device import resolve_device
from tensor2robot_tpu_torch.models import optimizers as opt_lib
from tensor2robot_tpu_torch.models.abstract_model import Metrics, TrainState
from tensor2robot_tpu_torch.ops import fused_cem_select
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.research.qtopt import networks as net_lib
from tensor2robot_tpu_torch.research.qtopt.t2r_models import GraspingQModel
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    make_random_tensors,
)
from tensor2robot_tpu_torch.utils import tree

_UNCALIBRATED = ("cem_inference='int8' needs activation scales: call "
                 "learner.calibrate(state, batch) (or ensure_calibrated) "
                 "before tracing the step/policy.")


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


def _capturing(device: torch.device) -> bool:
  """Whether this thread is capturing a CUDA graph on `device`."""
  return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


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


@gin.configurable
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

    cem_inference: "bf16" (the network's compute dtype) or "int8" (the
      quantized tower, `networks.quantize_tower`: int8 weights and
      activations, each conv on int8 values in the compute dtype,
      activation scales from `calibrate()`). Bellman targets and acting
      only; the critic's gradient path is untouched. Weight scales are
      recomputed from the network's tensors on every call, inside a
      captured step too.
    cem_select: "lax" (sort + gather, the reference path) or "fused"
      (scoring + top-E + elite stats in the `ops.fused_cem_select`
      kernel through `cem_maximize`'s select_fn seam).
    `clip_targets` applies only with the model's `sigmoid_q`.

    Calibration and captured graphs. As in the JAX package, where the
    activation scales are constants of each traced program, a CUDA
    graph keeps the scales it was captured with: a step or policy that
    runs eagerly reads the current scales on every call, a graph
    captured before a later `calibrate()` goes on reading the old ones
    (their device tensors are kept, never overwritten or freed). That
    is never silent: `calibrate()` warns (`RuntimeWarning`) when a
    capture has read the scales it replaces. Calibrate before building
    the engine or the training loop, as `train_qtopt` and
    `CEMPolicyServer` do; rebuild them after recalibrating.
    """
    if cem_inference not in ("bf16", "int8"):
      raise ValueError(f"cem_inference={cem_inference!r} not in "
                       "('bf16', 'int8')")
    if cem_select not in ("lax", "fused"):
      raise ValueError(f"cem_select={cem_select!r} not in "
                       "('lax', 'fused')")
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
    self._act_scales: Optional[Dict[str, float]] = None
    # Each calibration's scales as f32 device tensors, per device; a
    # calibration's tensors are kept (a graph captured over them reads
    # them for its lifetime). `_scales_captured`: a capture read the
    # current calibration's tensors.
    self._scale_tensors: Dict[Tuple[int, str], Dict[str, torch.Tensor]] = {}
    self._calibration = 0
    self._scales_captured = False

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

  # ---- int8 calibration ----

  @property
  def needs_calibration(self) -> bool:
    """True when the int8 tower is selected but no activation scales
    exist yet: `calibrate()` (or `ensure_calibrated()`) must run before
    a step or policy does."""
    return self._cem_inference == "int8" and self._act_scales is None

  @property
  def act_scales(self) -> Optional[Dict[str, float]]:
    """The calibrated per-tensor activation scales (host floats)."""
    return None if self._act_scales is None else dict(self._act_scales)

  def calibrate(self, state, features) -> Dict[str, float]:
    """Computes the int8 activation scales from a held-out batch.

    `state` is a QTOptState or TrainState (its online params and batch
    statistics, in eval mode); `features` a batch of the model's TRAIN
    features (a transition batch works: its ``next_*``, ``reward`` and
    ``done`` are dropped first), numpy or tensors. Returns the scales
    (host floats)."""
    ts = state.train_state if isinstance(state, QTOptState) else state
    device = _state_device(ts)
    flat = dict(features.to_flat_dict() if hasattr(features, "to_flat_dict")
                else features)
    flat = {k: torch.as_tensor(v, device=device) for k, v in flat.items()
            if not k.startswith("next_") and k not in ("reward", "done")}
    with torch.no_grad():
      stats = self._model.bind(ts).calibration_stats(flat)
    if self._scales_captured:
      warnings.warn(
          "QTOptLearner.calibrate(): a CUDA graph captured over the previous "
          "activation scales keeps them, as a traced JAX step keeps its "
          "constants; build the engine or training loop anew to use the "
          "new scales.", RuntimeWarning, stacklevel=2)
    self._act_scales = net_lib.scales_from_stats(
        {k: v.item() for k, v in stats.items()})
    self._calibration += 1
    self._scales_captured = False
    return dict(self._act_scales)

  def ensure_calibrated(self, state) -> None:
    """Calibrates from a spec-random batch (16 rows, seed 0) when no
    calibration ran: serving contexts that never see a replay batch."""
    if not self.needs_calibration:
      return
    batch = make_random_tensors(
        self._model.get_feature_specification(Mode.TRAIN), batch_size=16,
        seed=0)
    self.calibrate(state, batch.to_flat_dict())

  def _act_scale_tensors(self, device: torch.device) -> Dict[str, torch.Tensor]:
    """The current calibration's scales as f32 0-dim tensors on
    `device`, made outside any capture (a step's warm-up makes them)."""
    if self._act_scales is None:
      raise RuntimeError(_UNCALIBRATED)
    key = (self._calibration, str(device))
    found = self._scale_tensors.get(key)
    if found is None:
      found = {k: net_lib._scale_tensor(v, device)
               for k, v in self._act_scales.items()}
      self._scale_tensors[key] = found
    if _capturing(device):
      self._scales_captured = True
    return found

  def create_state(self, seed: int = 0) -> QTOptState:
    """Params, batch stats and Adam state from `seed`; the target is a
    distinct copy of the params."""
    train_state = self._model.create_train_state(seed, self._device)
    target = {k: v.clone() for k, v in train_state.params.items()}
    return QTOptState(train_state=train_state, target_params=target)

  def _cem_fns(self, network, state_features):
    """(score_fn, select_fn) for `cem_maximize` — exactly one is used.

    The four paths: bf16/int8 tower × lax/fused select. Each runs the
    torso ONCE per state; int8 swaps the tower for the quantized twin
    (requantizing the network's weights here, on every call); "fused"
    routes the scoring tail through `ops.fused_cem_select` via the
    select seam (the kernel applies the sigmoid of a `sigmoid_q` model
    itself).
    """
    if self._cem_inference == "bf16" and self._cem_select == "lax":
      return cem.make_encoded_q_score_fn(network, state_features), None
    flat_state = dict(state_features.to_flat_dict()
                      if hasattr(state_features, "to_flat_dict")
                      else state_features)
    image = flat_state.pop("image")
    extras = {k: v for k, v in flat_state.items() if k != "action"}
    if self._cem_inference == "int8":
      tower = net_lib.quantize_tower(
          network, self._act_scale_tensors(image.device))
      encoded = net_lib.quantized_encode(network, tower, image)
      score_fn = lambda actions: net_lib.quantized_score_population(  # noqa: E731
          network, tower, encoded, extras, actions)
      pool_fn = lambda actions: net_lib.quantized_pool_population(  # noqa: E731
          network, tower, encoded, extras, actions)
    else:
      encoded = network.encode(image)
      score_fn = lambda actions: network.score_population(  # noqa: E731
          encoded, extras, actions)
      pool_fn = lambda actions: network.pool_population(  # noqa: E731
          encoded, extras, actions)
    if self._cem_select != "fused":
      return score_fn, None
    dense = net_lib.q_head_dense_params(network, dtype=network.dtype)
    sigmoid = self._model.sigmoid_q

    def select_fn(actions, min_std):
      return fused_cem_select(
          pool_fn(actions), actions, dense, num_elites=self._cem_elites,
          min_std=min_std, sigmoid=sigmoid)

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
          f"axis_name={axis_name!r}: pmap-style steps are not ported "
          "yet (ROADMAP A11 rest); a learner group's step runs inside "
          "parallel.collectives.data_parallel.")
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
    group = collectives.active_group()
    if group is not None:
      # One rank of a learner group: its rows' gradients (batch norm
      # already normalized with the global batch's moments) and metrics
      # averaged over the group, so every rank applies the gradient of
      # the global batch's mean loss, as the JAX mesh's step does.
      grads = collectives.all_reduce_mean(grads, group)
      metrics = collectives.all_reduce_mean(metrics, group)
      metrics["grad_norm"] = opt_lib.global_norm(grads)
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
                   cem_iterations: Optional[int] = None,
                   no_grad: bool = False):
    """Returns (state, observations, generator=None, noise=None) →
    best actions [B, A] (f32, on the state's device).

    `state` is a `QTOptState` or a bare critic `TrainState` (acting
    reads only the online params). Observations are a struct/dict of
    tensors or numpy arrays with a leading batch dim; numpy leaves are
    moved to the state's device. Noise comes from `generator` (on that
    device) or is given whole as `noise` `[iterations, B, P, A]`.
    The CEM runs in inference mode, or under `no_grad` with `no_grad`:
    then its actions may enter tensors that a later autograd step reads
    (the Anakin collection writes them into its replay ring).
    """
    grad_mode = torch.no_grad if no_grad else torch.inference_mode

    def policy(state, observations, generator=None, noise=None):
      ts = state.train_state if isinstance(state, QTOptState) else state
      device = _state_device(ts)
      obs = tree.map_structure(
          lambda x: torch.as_tensor(x, device=device), observations)
      batch = tree.leaves(obs)[0].shape[0]
      with grad_mode():
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
