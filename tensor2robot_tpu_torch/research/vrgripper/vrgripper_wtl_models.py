"""Watch-Try-Learn: trial-conditioned gripper policies (port of
`research/vrgripper/vrgripper_wtl_models.py`).

A trial policy conditioned on a watched demonstration proposes an
attempt; a retrial policy conditioned on the demonstration and the
executed trial (with its rewards) improves on it. Episode embeddings are
mean-pooled per-step encodings with the step dim folded into the batch
dim (one conv batch for all tasks × steps); conditioning is plain
concatenation. Both policies are one class: `policy_type='trial'` drops
the trial split from the specs and the network.

Meta-batch layout (B tasks):
  features.condition/…   demo observations     [B, N_demo, …]
  features.trial/…       trial obs + action + reward  [B, N_trial, …]
                         (retrial policy only)
  features.inference/…   query observations    [B, N_query, …]
  labels.condition/action  demo actions [B, N_demo, A]
  labels.inference/action  target actions [B, N_query, A]
At predict time demo actions ride in the features under
condition_labels/action (optional: absent means unconditioned).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.layers.core import MLP
from tensor2robot_tpu_torch.meta_learning.maml_model import (
    CONDITION,
    CONDITION_LABELS,
    INFERENCE,
    _flat,
    _split,
)
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_models import (
    ACTION,
    GripperObsEncoder,
    action_head_outputs,
    action_supervision_loss,
    make_action_head,
)
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct

TRIAL = "trial"
REWARD = "reward"

TRIAL_POLICY = "trial"
RETRIAL_POLICY = "retrial"


class _WTLPolicyNet(nn.Module):
  """Demo (+ trial) episode embeddings conditioning a query policy."""

  def __init__(self, action_dim: int, state_dim: int, num_condition: int,
               num_trial: int, num_inference: int, filters: Sequence[int],
               embedding_size: int, hidden_sizes: Sequence[int],
               num_mixture_components: int,
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.action_dim = action_dim
    self.num_condition = num_condition
    self.num_trial = num_trial  # 0 for the trial policy
    self.num_inference = num_inference
    self.dtype = dtype
    e = embedding_size
    self.obs_encoder = GripperObsEncoder(
        state_dim, filters=tuple(filters), embedding_size=e,
        use_batch_norm=False, dtype=dtype)
    self.demo_embed = MLP(e + action_dim, (e,), output_size=e, dtype=dtype)
    if num_trial > 0:
      self.trial_embed = MLP(e + action_dim + 1, (e,), output_size=e,
                             dtype=dtype)
    hidden_sizes = tuple(hidden_sizes)
    self.trunk = MLP(e + e * (2 if num_trial > 0 else 1), hidden_sizes,
                     dtype=dtype, activate_final=True)
    width = hidden_sizes[-1] if hidden_sizes else 2 * e + (
        e if num_trial > 0 else 0)
    self.head_name = "mdn_head" if num_mixture_components > 0 else (
        "action_head")
    self.add_module(self.head_name, make_action_head(
        width, action_dim, num_mixture_components, dtype))

  def forward(self, features) -> Dict[str, torch.Tensor]:
    flat = _flat(features)
    cond = _split(flat, CONDITION)
    first = next(iter(cond.values()))
    num_tasks, device, dtype = first.shape[0], first.device, self.dtype

    def encode(split, n):
      folded = {k: v.reshape((num_tasks * n,) + tuple(v.shape[2:]))
                for k, v in split.items()}
      return self.obs_encoder(folded).reshape(num_tasks, n, -1)

    def embed(mlp, steps, n):
      out = mlp(steps.reshape(num_tasks * n, -1)).reshape(num_tasks, n, -1)
      return torch.mean(out, dim=1)  # [B, E], over the steps

    # Demonstration embedding: per-step [obs_emb ‖ action] → MLP → mean.
    cond_emb = encode(cond, self.num_condition)
    demo_key = f"{CONDITION_LABELS}/{ACTION}"
    if demo_key in flat:
      demo_actions = flat[demo_key].to(dtype)
    else:
      demo_actions = torch.zeros(
          (num_tasks, self.num_condition, self.action_dim), dtype=dtype,
          device=device)
    demo_step = torch.cat([cond_emb.to(dtype), demo_actions], dim=-1)
    context = [embed(self.demo_embed, demo_step,
                     self.num_condition).to(dtype)]

    if self.num_trial > 0:
      trial = _split(flat, TRIAL)
      trial_obs = {k: v for k, v in trial.items()
                   if k not in (ACTION, REWARD)}
      trial_step = torch.cat([
          encode(trial_obs, self.num_trial).to(dtype),
          trial[ACTION].to(dtype),
          trial[REWARD].to(dtype),
      ], dim=-1)
      context.append(embed(self.trial_embed, trial_step,
                           self.num_trial).to(dtype))

    # Query policy: [query_emb ‖ context…] → trunk → action head.
    inf_emb = encode(_split(flat, INFERENCE), self.num_inference)
    ctx = torch.cat(context, dim=-1)[:, None, :].expand(
        num_tasks, self.num_inference, -1)
    query = torch.cat([inf_emb.to(dtype), ctx], dim=-1)
    trunk = self.trunk(query.reshape(num_tasks * self.num_inference, -1))
    outputs = action_head_outputs(getattr(self, self.head_name), trunk,
                                  dtype)
    return {k: v.reshape((num_tasks, self.num_inference) + tuple(v.shape[1:]))
            for k, v in outputs.items()}


@gin.configurable
class VRGripperWTLModel(AbstractT2RModel):
  """Watch-Try-Learn policy (`policy_type`: 'trial' or 'retrial')."""

  def __init__(self,
               policy_type: str = RETRIAL_POLICY,
               image_size: int = 48,
               state_dim: int = 3,
               action_dim: int = 3,
               filters: Sequence[int] = (16, 32),
               embedding_size: int = 64,
               hidden_sizes: Sequence[int] = (64,),
               num_mixture_components: int = 0,
               num_condition_samples_per_task: int = 4,
               num_trial_samples_per_task: int = 4,
               num_inference_samples_per_task: int = 4,
               device_dtype: torch.dtype = torch.bfloat16,
               **kwargs):
    if policy_type not in (TRIAL_POLICY, RETRIAL_POLICY):
      raise ValueError(f"Unknown policy_type: {policy_type!r}")
    super().__init__(device_dtype=device_dtype, **kwargs)
    self._policy_type = policy_type
    self._image_size = image_size
    self._state_dim = state_dim
    self._action_dim = action_dim
    self._filters = tuple(filters)
    self._embedding_size = embedding_size
    self._hidden_sizes = tuple(hidden_sizes)
    self._num_mixture_components = num_mixture_components
    self._num_condition = num_condition_samples_per_task
    self._num_trial = (num_trial_samples_per_task
                       if policy_type == RETRIAL_POLICY else 0)
    self._num_inference = num_inference_samples_per_task

  @property
  def policy_type(self) -> str:
    return self._policy_type

  def _obs_specs(self, n: int, prefix: str) -> Dict[str, Any]:
    return {
        "image": ExtendedTensorSpec(
            shape=(n, self._image_size, self._image_size, 3),
            dtype=np.uint8, name=f"{prefix}_image"),
        "gripper_pose": ExtendedTensorSpec(
            shape=(n, self._state_dim), dtype=np.float32,
            name=f"{prefix}_gripper_pose"),
    }

  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    flat = {}
    for key, spec in self._obs_specs(self._num_condition,
                                     CONDITION).items():
      flat[f"{CONDITION}/{key}"] = spec
    if self._num_trial > 0:
      for key, spec in self._obs_specs(self._num_trial, TRIAL).items():
        flat[f"{TRIAL}/{key}"] = spec
      flat[f"{TRIAL}/{ACTION}"] = ExtendedTensorSpec(
          shape=(self._num_trial, self._action_dim), dtype=np.float32,
          name="trial_action")
      flat[f"{TRIAL}/{REWARD}"] = ExtendedTensorSpec(
          shape=(self._num_trial, 1), dtype=np.float32,
          name="trial_reward")
    for key, spec in self._obs_specs(self._num_inference,
                                     INFERENCE).items():
      flat[f"{INFERENCE}/{key}"] = spec
    if mode == Mode.PREDICT:
      # Demo actions for serving-time conditioning (absent: zeros).
      flat[f"{CONDITION_LABELS}/{ACTION}"] = ExtendedTensorSpec(
          shape=(self._num_condition, self._action_dim),
          dtype=np.float32, name="condition_action", is_optional=True)
    return TensorSpecStruct.from_flat_dict(flat)

  def get_label_specification(self, mode: Mode) -> TensorSpecStruct:
    return TensorSpecStruct.from_flat_dict({
        f"{CONDITION}/{ACTION}": ExtendedTensorSpec(
            shape=(self._num_condition, self._action_dim),
            dtype=np.float32, name="demo_action"),
        f"{INFERENCE}/{ACTION}": ExtendedTensorSpec(
            shape=(self._num_inference, self._action_dim),
            dtype=np.float32, name="target_action"),
    })

  def create_network(self) -> nn.Module:
    return _WTLPolicyNet(
        action_dim=self._action_dim,
        state_dim=self._state_dim,
        num_condition=self._num_condition,
        num_trial=self._num_trial,
        num_inference=self._num_inference,
        filters=self._filters,
        embedding_size=self._embedding_size,
        hidden_sizes=self._hidden_sizes,
        num_mixture_components=self._num_mixture_components,
        dtype=self.device_dtype,
    )

  def network_inputs_from_labels(self, features, labels, mode):
    """Demo actions are conditioning input: lifted from the labels into
    the features (at predict time they arrive under condition_labels/
    directly)."""
    if not labels:
      return features
    flat = dict(_flat(features))
    flat[f"{CONDITION_LABELS}/{ACTION}"] = _flat(labels)[
        f"{CONDITION}/{ACTION}"]
    return flat

  def model_train_fn(self, features, labels, outputs, mode
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return action_supervision_loss(outputs,
                                   _flat(labels)[f"{INFERENCE}/{ACTION}"])
