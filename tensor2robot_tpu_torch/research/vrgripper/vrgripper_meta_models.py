"""VRGripper meta-BC: MAML and SNAIL (in-context) variants (port of
`research/vrgripper/vrgripper_meta_models.py`).

The MAML variant inherits `MAMLModel`'s inner loop over the BN-free
gripper BC policy. The SNAIL variant runs the shared observation encoder
over all task steps folded into one conv batch, then one causal SNAIL
trunk over [demo steps ‖ query steps]: demonstrations condition the
queries through attention, with no per-task loop.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.layers.snail import SNAIL
from tensor2robot_tpu_torch.meta_learning.maml_model import (
    CONDITION,
    CONDITION_LABELS,
    INFERENCE,
    MAMLModel,
    _flat,
    _split,
)
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_models import (
    ACTION,
    GripperObsEncoder,
    VRGripperRegressionModel,
    action_head_outputs,
    action_supervision_loss,
    make_action_head,
)


@gin.configurable
class VRGripperMAMLModel(MAMLModel):
  """MAML over the (BN-free) gripper BC policy: per-task demonstrations
  adapt the policy by K inner gradient steps, and the adapted policy is
  scored on held-out steps of the same task."""

  def __init__(self,
               image_size: int = 48,
               state_dim: int = 3,
               action_dim: int = 3,
               filters: Sequence[int] = (16, 32),
               embedding_size: int = 64,
               hidden_sizes: Sequence[int] = (64,),
               num_mixture_components: int = 0,
               num_inner_steps: int = 1,
               inner_lr: float = 0.05,
               first_order: bool = False,
               num_condition_samples_per_task: int = 4,
               num_inference_samples_per_task: int = 4,
               **kwargs):
    base = VRGripperRegressionModel(
        image_size=image_size, state_dim=state_dim,
        action_dim=action_dim, filters=filters,
        embedding_size=embedding_size, hidden_sizes=hidden_sizes,
        num_mixture_components=num_mixture_components,
        use_batch_norm=False)
    super().__init__(
        base_model=base,
        num_inner_steps=num_inner_steps,
        inner_lr=inner_lr,
        first_order=first_order,
        num_condition_samples_per_task=num_condition_samples_per_task,
        num_inference_samples_per_task=num_inference_samples_per_task,
        **kwargs)


class _SNAILMetaPolicy(nn.Module):
  """Demo-conditioned policy: encoder per step, SNAIL across steps.

  Demo steps enter the sequence with their actions appended and a
  presence flag of 1 (actions from ``condition_labels/action``, zeros
  when absent); query steps with zeros. The causal trunk lets each query
  attend to the whole demonstration and to earlier queries. Output: per
  query, the action (or the MDN params).
  """

  def __init__(self, action_dim: int, state_dim: int, num_condition: int,
               num_inference: int, filters: Sequence[int],
               embedding_size: int, snail_filters: int,
               num_mixture_components: int,
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.action_dim = action_dim
    self.num_condition = num_condition
    self.num_inference = num_inference
    self.dtype = dtype
    self.obs_encoder = GripperObsEncoder(
        state_dim, filters=tuple(filters), embedding_size=embedding_size,
        use_batch_norm=False, dtype=dtype)
    self.snail_trunk = SNAIL(embedding_size + action_dim + 1,
                             seq_len=num_condition + num_inference,
                             filters=snail_filters, dtype=dtype)
    self.head_name = "mdn_head" if num_mixture_components > 0 else (
        "action_head")
    self.add_module(self.head_name, make_action_head(
        self.snail_trunk.out_channels, action_dim, num_mixture_components,
        dtype))

  def forward(self, features) -> Dict[str, torch.Tensor]:
    flat = _flat(features)
    cond, inf = _split(flat, CONDITION), _split(flat, INFERENCE)
    first = next(iter(cond.values()))
    num_tasks, device, dtype = first.shape[0], first.device, self.dtype
    n_c, n_i = self.num_condition, self.num_inference

    def encode(split, n):
      folded = {k: v.reshape((num_tasks * n,) + tuple(v.shape[2:]))
                for k, v in split.items()}
      return self.obs_encoder(folded).reshape(num_tasks, n, -1)

    cond_emb = encode(cond, n_c)
    inf_emb = encode(inf, n_i)
    demo_key = f"{CONDITION_LABELS}/{ACTION}"
    if demo_key in flat:
      demo_actions = flat[demo_key].to(dtype)
    else:
      demo_actions = torch.zeros((num_tasks, n_c, self.action_dim),
                                 dtype=dtype, device=device)
    ones = torch.ones((num_tasks, n_c, 1), dtype=dtype, device=device)
    zeros_a = torch.zeros((num_tasks, n_i, self.action_dim), dtype=dtype,
                          device=device)
    zeros_f = torch.zeros((num_tasks, n_i, 1), dtype=dtype, device=device)
    cond_in = torch.cat([cond_emb.to(dtype), demo_actions, ones], dim=-1)
    inf_in = torch.cat([inf_emb.to(dtype), zeros_a, zeros_f], dim=-1)
    out = self.snail_trunk(torch.cat([cond_in, inf_in], dim=1))
    query = out[:, n_c:, :]  # [B, n_i, D]
    return action_head_outputs(getattr(self, self.head_name), query, dtype)


@gin.configurable
class VRGripperSNAILModel(MAMLModel):
  """In-context meta-BC: demonstrations condition through attention.

  `MAMLModel`'s meta spec layout and preprocessor (condition/inference
  splits; predict-time demonstration actions under condition_labels),
  with a SNAIL trunk in place of gradient adaptation.
  """

  def __init__(self,
               image_size: int = 48,
               state_dim: int = 3,
               action_dim: int = 3,
               filters: Sequence[int] = (16, 32),
               embedding_size: int = 64,
               snail_filters: int = 32,
               num_mixture_components: int = 0,
               num_condition_samples_per_task: int = 4,
               num_inference_samples_per_task: int = 4,
               **kwargs):
    base = VRGripperRegressionModel(
        image_size=image_size, state_dim=state_dim,
        action_dim=action_dim, filters=filters,
        embedding_size=embedding_size,
        num_mixture_components=num_mixture_components,
        use_batch_norm=False)
    super().__init__(
        base_model=base,
        num_condition_samples_per_task=num_condition_samples_per_task,
        num_inference_samples_per_task=num_inference_samples_per_task,
        **kwargs)
    self._state_dim = state_dim
    self._action_dim = action_dim
    self._filters = tuple(filters)
    self._embedding_size = embedding_size
    self._snail_filters = snail_filters
    self._num_mixture_components = num_mixture_components

  def create_network(self) -> nn.Module:
    return _SNAILMetaPolicy(
        action_dim=self._action_dim,
        state_dim=self._state_dim,
        num_condition=self._num_condition,
        num_inference=self._num_inference,
        filters=self._filters,
        embedding_size=self._embedding_size,
        snail_filters=self._snail_filters,
        num_mixture_components=self._num_mixture_components,
        dtype=self._base.device_dtype,
    )

  def network_inputs_from_labels(self, features, labels, mode):
    """Demonstration labels condition the trunk: every condition label
    is lifted under condition_labels/ (at predict time they arrive
    there directly)."""
    if not labels:
      return features
    flat = dict(_flat(features))
    for key, value in _split(labels, CONDITION).items():
      flat[f"{CONDITION_LABELS}/{key}"] = value
    return flat

  def loss_fn(self, params, batch_stats, features, labels, mode):
    # In-context conditioning replaces gradient adaptation: the plain
    # supervised loss (with the labels-as-inputs hook) applies.
    return AbstractT2RModel.loss_fn(self, params, batch_stats, features,
                                    labels, mode)

  def model_train_fn(self, features, labels, outputs, mode
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return action_supervision_loss(outputs,
                                   labels[f"{INFERENCE}/{ACTION}"])

  # Its predict_step conditions in context, without the inner gradient.
  predict_step_has_function_transforms = False

  def predict_step(self, state, features) -> Any:
    # Demonstration actions, when supplied, already ride in the features
    # under condition_labels/ through the MAML preprocessor.
    return AbstractT2RModel.predict_step(self, state, features)
