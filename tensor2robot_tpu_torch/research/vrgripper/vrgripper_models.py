"""VRGripper behavioural-cloning policies: MSE and MDN heads (port of
`research/vrgripper/vrgripper_models.py`).

`GripperObsEncoder` is the torso every vrgripper policy shares (BC,
meta-BC, WTL, the transformer); `_GripperPolicyNet` puts an MLP trunk
and a plain or mixture-density action head on it, and
`VRGripperRegressionModel` trains it on (image, gripper_pose) → action
transitions. `action_supervision_loss` is the one action loss every
gripper policy shares: MDN NLL when the outputs carry mixture params,
MSE otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.layers.core import MLP, dense
from tensor2robot_tpu_torch.layers.mdn import (
    MDNHead,
    MDNParams,
    mdn_loss,
    mdn_mode,
    mdn_sample,
)
from tensor2robot_tpu_torch.layers.vision_layers import ImageEncoder
from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    TrainState,
)
from tensor2robot_tpu_torch.models.regression_model import INFERENCE_OUTPUT
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct

ACTION = "action"
# Auxiliary output keys of the MDN head (the mixture parameters ride
# along so serving-side samplers can draw their own actions).
MDN_LOGITS = "mdn_logits"
MDN_MEANS = "mdn_means"
MDN_LOG_SCALES = "mdn_log_scales"


class GripperObsEncoder(nn.Module):
  """{image [N, H, W, 3] uint8, gripper_pose [N, S]} → [N, E] embedding.

  Conv tower + spatial softmax over the image, the pose concatenated
  after pooling, one joint projection. Dtypes follow flax: image/255
  in the compute dtype; the image embedding comes back f32; the pose
  is cast to the compute dtype, and the concat promotes both to f32;
  `joint_proj` computes (and returns) in the compute dtype.
  """

  def __init__(self, state_dim: int,
               filters: Sequence[int] = (32, 64),
               embedding_size: int = 64,
               use_batch_norm: bool = False,
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.dtype = dtype
    self.image_encoder = ImageEncoder(
        in_channels=3, filters=tuple(filters),
        embedding_size=embedding_size, pooling="spatial_softmax",
        use_batch_norm=use_batch_norm, dtype=dtype)
    self.joint_proj = nn.Linear(embedding_size + state_dim, embedding_size)

  def forward(self, features) -> torch.Tensor:
    image = features["image"]
    # A 0-dim device tensor, made by a fill (no host copy, so a CUDA
    # graph can capture it): a true division, as flax's, where a Python
    # scalar divisor would become a multiply by its reciprocal on CUDA.
    x = image.to(self.dtype) / torch.full((), 255.0, dtype=self.dtype,
                                          device=image.device)
    emb = self.image_encoder(x)
    state = features["gripper_pose"].to(self.dtype)
    joint = torch.cat([emb, state.to(emb.dtype)], dim=-1)
    return dense(self.joint_proj, joint, self.dtype)


def action_head_outputs(head: nn.Module, trunk: torch.Tensor,
                        dtype: torch.dtype) -> Dict[str, torch.Tensor]:
  """The policy output dict of an action head over `trunk` features: an
  `MDNHead` gives its greedy mode as the action plus the mixture params
  under the `MDN_*` keys; a Linear gives the action in f32."""
  if isinstance(head, MDNHead):
    params = head(trunk)
    action = mdn_mode(params)
    return {ACTION: action, INFERENCE_OUTPUT: action,
            MDN_LOGITS: params.logits, MDN_MEANS: params.means,
            MDN_LOG_SCALES: params.log_scales}
  action = dense(head, trunk, dtype).float()
  return {ACTION: action, INFERENCE_OUTPUT: action}


def make_action_head(in_features: int, action_dim: int,
                     num_mixture_components: int,
                     dtype: torch.dtype) -> nn.Module:
  """``mdn_head`` (an `MDNHead`) when `num_mixture_components` > 0, else
  ``action_head`` (a Linear): the caller names the attribute."""
  if num_mixture_components > 0:
    return MDNHead(in_features, num_mixture_components, action_dim,
                   dtype=dtype)
  return nn.Linear(in_features, action_dim)


class _GripperPolicyNet(nn.Module):
  """Observation encoder + action head (plain or mixture-density)."""

  def __init__(self, action_dim: int, state_dim: int,
               filters: Sequence[int], embedding_size: int,
               hidden_sizes: Sequence[int], num_mixture_components: int,
               use_batch_norm: bool, dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.dtype = dtype
    self.obs_encoder = GripperObsEncoder(
        state_dim, filters=tuple(filters), embedding_size=embedding_size,
        use_batch_norm=use_batch_norm, dtype=dtype)
    hidden_sizes = tuple(hidden_sizes)
    self.trunk = MLP(embedding_size, hidden_sizes, dtype=dtype,
                     activate_final=True)
    width = hidden_sizes[-1] if hidden_sizes else embedding_size
    head = make_action_head(width, action_dim, num_mixture_components,
                            dtype)
    self.head_name = "mdn_head" if num_mixture_components > 0 else (
        "action_head")
    self.add_module(self.head_name, head)

  def forward(self, features) -> Dict[str, torch.Tensor]:
    emb = self.obs_encoder(features)
    trunk = self.trunk(emb)
    return action_head_outputs(getattr(self, self.head_name), trunk,
                               self.dtype)


def mdn_params_from_outputs(outputs) -> Optional[MDNParams]:
  """Recovers mixture parameters from a policy's output dict."""
  if MDN_LOGITS not in outputs:
    return None
  return MDNParams(outputs[MDN_LOGITS], outputs[MDN_MEANS],
                   outputs[MDN_LOG_SCALES])


def action_supervision_loss(outputs, target: torch.Tensor
                            ) -> Tuple[torch.Tensor,
                                       Dict[str, torch.Tensor]]:
  """(loss, metrics) for action cloning: MDN NLL when the output dict
  carries mixture params, MSE otherwise."""
  target = target.float()
  predicted = outputs[ACTION].float()
  action_error = torch.mean(torch.abs(predicted - target))
  params = mdn_params_from_outputs(outputs)
  if params is not None:
    loss = mdn_loss(params, target)
    return loss, {"nll": loss, "action_error": action_error}
  loss = torch.mean(torch.square(predicted - target))
  return loss, {"mse": loss, "action_error": action_error}


@gin.configurable
class VRGripperRegressionModel(AbstractT2RModel):
  """BC policy: clone expert actions from (image, gripper_pose).

  `num_mixture_components=0` gives the plain MSE regression policy;
  `>0` the MDN policy (NLL loss, greedy-mode action at predict time).
  """

  def __init__(self,
               image_size: int = 48,
               state_dim: int = 3,
               action_dim: int = 3,
               filters: Sequence[int] = (32, 64),
               embedding_size: int = 64,
               hidden_sizes: Sequence[int] = (64,),
               num_mixture_components: int = 0,
               use_batch_norm: bool = False,
               device_dtype: torch.dtype = torch.bfloat16,
               **kwargs):
    super().__init__(device_dtype=device_dtype, **kwargs)
    self._image_size = image_size
    self._state_dim = state_dim
    self._action_dim = action_dim
    self._filters = tuple(filters)
    self._embedding_size = embedding_size
    self._hidden_sizes = tuple(hidden_sizes)
    self._num_mixture_components = num_mixture_components
    self._use_batch_norm = use_batch_norm

  @property
  def action_dim(self) -> int:
    return self._action_dim

  @property
  def uses_mdn(self) -> bool:
    return self._num_mixture_components > 0

  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.image = ExtendedTensorSpec(
        shape=(self._image_size, self._image_size, 3), dtype=np.uint8,
        name="image", data_format="png")
    st.gripper_pose = ExtendedTensorSpec(
        shape=(self._state_dim,), dtype=np.float32, name="gripper_pose")
    return st

  def get_label_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.action = ExtendedTensorSpec(
        shape=(self._action_dim,), dtype=np.float32, name=ACTION)
    return st

  def create_network(self) -> nn.Module:
    return _GripperPolicyNet(
        action_dim=self._action_dim,
        state_dim=self._state_dim,
        filters=self._filters,
        embedding_size=self._embedding_size,
        hidden_sizes=self._hidden_sizes,
        num_mixture_components=self._num_mixture_components,
        use_batch_norm=self._use_batch_norm,
        dtype=self.device_dtype,
    )

  def model_train_fn(self, features, labels, outputs, mode
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return action_supervision_loss(outputs, labels[ACTION])

  def sample_action(self, state: TrainState, features,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Draws a stochastic action from `generator` (MDN) or returns the
    regressed action (MSE)."""
    outputs = self.predict_step(state, features)
    params = mdn_params_from_outputs(outputs)
    if params is None:
      return outputs[ACTION]
    return mdn_sample(params, generator)
