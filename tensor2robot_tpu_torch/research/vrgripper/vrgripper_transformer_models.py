"""Long-context transformer BC over gripper episodes (port of
`research/vrgripper/vrgripper_transformer_models.py`).

Every step of every episode goes through the shared `GripperObsEncoder`
as one conv batch, a causal transformer runs over the steps, and a
dense head gives each step's action. On the card the trunk's attention
is the hand-written flash kernel (`attention_impl="auto"`).

Ported: the network, the model's specs, the length-masked per-step BC
loss (`model_train_fn`) that trains it, and `EpisodeContextPolicy`, the
on-robot loop that feeds the growing history. `moe_experts` and
`moe_every` make every `moe_every`-th trunk block a MoE layer on one
device (`parallel.moe`); the network then returns the trunk's
load-balance loss under `AbstractT2RModel.AUX_LOSS_OUTPUT`, which the
base model weights into the loss by `aux_loss_weight` and strips from
`predict_step`.

`pipeline_stages` splits the trunk's depth into that many GPipe stages
(`layers.pipelined_transformer`); with a `mesh` whose `stage` axis has
that many ranks each rank holds one stage and the microbatches hop along
the stage ring, and without one the same stacked params run the
sequential fallback, so a checkpoint of the pipeline gin serves on one
device. On a mesh of more than one rank the masked loss keeps JAX's
global denominator (ROADMAP trap 63): each rank's loss is its rows'
share, sum(sq·mask) over its rows / max(sum(mask) over the data group,
1), the data group sums the shares' gradients, and the reported loss and
scalars are the shares summed over the group.

`attention_impl="ring"` (or "ring_flash") with a `mesh` whose `seq` axis
is above 1 splits each attention layer's time axis over the seq ranks
(`parallel.ring_attention`); every other layer runs whole on every seq
rank of a data row, so their gradients need no sum over `seq`. The
model without its mesh (`without_mesh`, a trainer's warm-up step, and
serving a checkpoint on one device) runs the same function on one
device: "ring" becomes "auto" and "ring_flash" "flash" (no parameter
depends on the backend). Expert parallelism waits for ROADMAP A11 rest.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.data.episode_input_generator import (
    SEQUENCE_LENGTH_KEY,
)
from tensor2robot_tpu_torch.device import DeviceLike, resolve_device
from tensor2robot_tpu_torch.layers.core import dense
from tensor2robot_tpu_torch.layers.pipelined_transformer import (
    STAGE_PARAMS_NAME,
    PipelinedCausalTransformer,
)
from tensor2robot_tpu_torch.layers.transformer import CausalTransformer
from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    TrainState,
)
from tensor2robot_tpu_torch.models import optimizers as opt_lib
from tensor2robot_tpu_torch.models.regression_model import INFERENCE_OUTPUT
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import pipeline as pipeline_lib
from tensor2robot_tpu_torch.parallel.mesh import DATA_AXIS, STAGE_AXIS
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_models import (
    ACTION,
    GripperObsEncoder,
)
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct
from tensor2robot_tpu_torch.utils.step_graph import StepGraph


class _EpisodeTransformerNet(nn.Module):
  """Per-step obs encoder → causal transformer → per-step actions."""

  def __init__(self, action_dim: int, state_dim: int,
               filters: Sequence[int], embedding_size: int, width: int,
               depth: int, num_heads: int, max_len: int,
               attention_impl: str, dtype: torch.dtype = torch.bfloat16,
               moe_experts: int = 0, moe_every: int = 2,
               pipeline_stages: int = 0, pipeline_microbatches: int = 2,
               pipeline_remat: bool = False, mesh=None):
    super().__init__()
    self.dtype = dtype
    self.obs_encoder = GripperObsEncoder(
        state_dim, filters=tuple(filters), embedding_size=embedding_size,
        use_batch_norm=False, dtype=dtype)
    if pipeline_stages:
      self.trunk = PipelinedCausalTransformer(
          embedding_size, width=width, depth=depth, num_heads=num_heads,
          max_len=max_len, num_stages=pipeline_stages,
          num_microbatches=pipeline_microbatches, remat=pipeline_remat,
          attention_impl=attention_impl, mesh=mesh, dtype=dtype)
    else:
      self.trunk = CausalTransformer(
          embedding_size, width=width, depth=depth, num_heads=num_heads,
          max_len=max_len, attention_impl=attention_impl, dtype=dtype,
          moe_experts=moe_experts, moe_every=moe_every, mesh=mesh)
    self.action_head = nn.Linear(width, action_dim)

  def forward(self, features) -> Dict[str, torch.Tensor]:
    flat = (features.to_flat_dict()
            if hasattr(features, "to_flat_dict") else dict(features))
    image = flat["image"]
    pose = flat["gripper_pose"]
    b, t = image.shape[:2]
    # All steps of all episodes through ONE conv batch.
    emb = self.obs_encoder({
        "image": image.reshape((b * t,) + tuple(image.shape[2:])),
        "gripper_pose": pose.reshape((b * t,) + tuple(pose.shape[2:])),
    })
    if isinstance(self.trunk, PipelinedCausalTransformer):
      trunk, aux = self.trunk(emb.reshape(b, t, -1)), None
    else:
      trunk, aux = self.trunk(emb.reshape(b, t, -1), return_aux=True)
    action = dense(self.action_head, trunk, self.dtype).float()
    outputs = {ACTION: action, INFERENCE_OUTPUT: action}
    if aux is not None:
      outputs[AbstractT2RModel.AUX_LOSS_OUTPUT] = aux
    return outputs


@gin.configurable
class VRGripperTransformerModel(AbstractT2RModel):
  """Episode-level BC: every action conditioned on the full history."""

  def __init__(self,
               image_size: int = 48,
               state_dim: int = 3,
               action_dim: int = 3,
               filters: Sequence[int] = (16, 32),
               embedding_size: int = 64,
               width: int = 64,
               depth: int = 2,
               num_heads: int = 4,
               max_context_length: int = 512,
               attention_impl: str = "auto",
               mesh=None,
               moe_experts: int = 0,
               moe_every: int = 2,
               pipeline_stages: int = 0,
               pipeline_microbatches: int = 2,
               pipeline_remat: bool = False,
               device_dtype: torch.dtype = torch.bfloat16,
               **kwargs):
    """`moe_experts` / `moe_every`: every `moe_every`-th trunk block's
    MLP becomes that many routed experts (one device); the load-balance
    loss joins training by `aux_loss_weight`. `pipeline_stages`: split
    the trunk's depth into that many GPipe stages of
    `pipeline_microbatches` microbatches (`pipeline_remat` recomputes a
    stage's activations in the backward); with `mesh`
    (`parallel.mesh.create_mesh`) carrying a `stage` axis of the same
    size each rank holds one stage, and without one the same params run
    the sequential fallback. The global batch must divide into
    `pipeline_microbatches` × the mesh's data-axis size. Exclusive with
    `moe_experts`. `kwargs` go to `AbstractT2RModel`
    (`create_optimizer_fn`, `aux_loss_weight`)."""
    super().__init__(device_dtype=device_dtype, **kwargs)
    if pipeline_stages and moe_experts:
      raise ValueError(
          "pipeline_stages and moe_experts are mutually exclusive: the "
          "pipelined trunk stacks dense blocks (stage-stacked MoE routing "
          "is not implemented).")
    if (pipeline_stages and mesh is not None
        and STAGE_AXIS in mesh.axis_names
        and mesh.shape[STAGE_AXIS] != pipeline_stages):
      raise ValueError(
          f"pipeline_stages={pipeline_stages} must equal the mesh's "
          f"{STAGE_AXIS!r} axis size {mesh.shape[STAGE_AXIS]} (each "
          "device materializes exactly one stage).")
    self._mesh = mesh
    self._pipeline_microbatches = pipeline_microbatches
    self._pipeline_remat = pipeline_remat
    self._image_size = image_size
    self._state_dim = state_dim
    self._action_dim = action_dim
    self._filters = tuple(filters)
    self._embedding_size = embedding_size
    self._width = width
    self._depth = depth
    self._num_heads = num_heads
    self._max_len = max_context_length
    self._attention_impl = attention_impl
    self._moe_experts = moe_experts
    self._moe_every = moe_every
    self._pipeline_stages = pipeline_stages
    with torch.device("meta"):
      self.create_network()  # unsupported options raise here, not later

  @property
  def depth(self) -> int:
    return self._depth

  def without_mesh(self) -> "VRGripperTransformerModel":
    """`AbstractT2RModel.without_mesh`, the ring's backends mapped to
    their one-device equivalents ("ring" → "auto", "ring_flash" →
    "flash")."""
    twin = super().without_mesh()
    if twin is not self:
      twin._attention_impl = {"ring": "auto", "ring_flash": "flash"}.get(
          self._attention_impl, self._attention_impl)
    return twin

  @property
  def pipeline_microbatches(self) -> int:
    """M: how a data rank's rows of the global batch are laid out
    (`parallel.pipeline.data_rows`); 1 without a pipelined trunk."""
    return self._pipeline_microbatches if self._pipeline_stages else 1

  def _data_group(self):
    """(whether the loss spans a data group of ranks, its group)."""
    mesh = self._mesh
    if mesh is None or mesh.world_size < 2 or mesh.axis_size(DATA_AXIS) < 2:
      return False, None
    return True, mesh.group(DATA_AXIS)

  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.image = ExtendedTensorSpec(
        shape=(self._image_size, self._image_size, 3), dtype=np.uint8,
        name="image", data_format="png", is_sequence=True)
    st.gripper_pose = ExtendedTensorSpec(
        shape=(self._state_dim,), dtype=np.float32,
        name="gripper_pose", is_sequence=True)
    return st

  def get_label_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.action = ExtendedTensorSpec(
        shape=(self._action_dim,), dtype=np.float32, name=ACTION,
        is_sequence=True)
    return st

  def create_network(self) -> _EpisodeTransformerNet:
    return _EpisodeTransformerNet(
        action_dim=self._action_dim,
        state_dim=self._state_dim,
        filters=self._filters,
        embedding_size=self._embedding_size,
        width=self._width,
        depth=self._depth,
        num_heads=self._num_heads,
        max_len=self._max_len,
        attention_impl=self._attention_impl,
        dtype=self.device_dtype,
        moe_experts=self._moe_experts,
        moe_every=self._moe_every,
        pipeline_stages=self._pipeline_stages,
        pipeline_microbatches=self._pipeline_microbatches,
        pipeline_remat=self._pipeline_remat,
        mesh=self._mesh,
    )

  def model_train_fn(self, features, labels, outputs, mode
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-step action MSE over the real steps: a step counts when its
    index is below the episode's `sequence_length` (all steps count
    when the key is absent), averaged over max(counted steps, 1). Over a
    data group the count is the group's (the module docstring), and the
    loss and scalars are this rank's shares of the global ones."""
    target = labels[ACTION].float()                  # [B, T, A]
    predicted = outputs[ACTION].float()
    b, t = target.shape[:2]
    if SEQUENCE_LENGTH_KEY in features:
      lengths = features[SEQUENCE_LENGTH_KEY].reshape(b)
      mask = (torch.arange(t, device=target.device)[None, :]
              < lengths[:, None]).float()
    else:
      mask = torch.ones((b, t), device=target.device)
    spans, group = self._data_group()
    count = mask.sum()
    if spans:
      count = collectives.all_reduce_sum(count, group)
    denom = count.clamp_min(1.0)
    diff = predicted - target
    loss = ((diff * diff).sum(dim=-1) * mask).sum() / denom
    action_error = (diff.abs().sum(dim=-1) * mask).sum() / denom
    return loss, {"mse": loss, "action_error": action_error}

  def train_grads(self, state: TrainState, features, labels,
                  axis_name: Optional[str] = None):
    """`AbstractT2RModel.train_grads`; over a data group the gradients
    and the scalars are the rank's shares summed over the group, and
    `grad_norm` is the whole gradient's (the stage-stacked leaves' part
    summed over the stage ring)."""
    spans, group = self._data_group()
    pipelined = pipeline_lib.is_pipelined(self._mesh)
    if pipelined and self.tx.reads_norms:
      raise NotImplementedError(
          "an optimizer that reads norms over whole leaves (clipping by "
          "the global norm, lamb) on a stage rank, which holds one stage "
          "of each stacked leaf (ROADMAP A11 rest)")
    grads, new_stats, metrics = super().train_grads(
        state, features, labels, axis_name=axis_name)
    if not spans and not pipelined:
      return grads, new_stats, metrics
    if spans:
      grads = collectives.all_reduce_sum_dict(grads, group)
      shares = {k: v for k, v in metrics.items() if k != "grad_norm"}
      metrics = {**collectives.all_reduce_sum_dict(shares, group),
                 "grad_norm": metrics["grad_norm"]}
    metrics["grad_norm"] = self._grad_norm(grads)
    return grads, new_stats, metrics

  def _grad_norm(self, grads) -> torch.Tensor:
    """optax's `global_norm` of the whole gradient, where a stage rank
    holds one stage of the stacked leaves."""
    stacked = [k for k in grads if STAGE_PARAMS_NAME in k.split(".")]
    if not pipeline_lib.is_pipelined(self._mesh) or not stacked:
      return opt_lib.global_norm(grads)
    rest = opt_lib.global_norm({k: v for k, v in grads.items()
                                if k not in stacked})
    local = opt_lib.global_norm({k: grads[k] for k in stacked})
    ring = collectives.all_reduce_sum(local * local,
                                      self._mesh.group(STAGE_AXIS))
    return torch.sqrt(rest * rest + ring)

  def make_context_policy(self, state: TrainState,
                          context_length: Optional[int] = None,
                          device: DeviceLike = None, graphs: bool = True
                          ) -> "EpisodeContextPolicy":
    """A closed-loop policy that feeds the growing episode history."""
    return EpisodeContextPolicy(self, state,
                                context_length or self._max_len, device,
                                graphs=graphs)


class EpisodeContextPolicy:
  """On-robot wrapper: accumulates history, serves the latest action.

  The control loop calls `policy(single_observation_batch)` per step
  and `policy.reset()` at episode boundaries (the protocol
  `evaluate_gripper_policy` speaks). The state and a `[1, T, ...]`
  history buffer live on `device` (None = the CUDA card): each call
  writes its observation into the next slot (shifting the window once
  T steps are held), runs the whole padded context — one fixed shape
  for every step; causal masking makes the zero padding harmless — and
  returns the action at the last real slot. `steps` and `resets` count
  the calls and episode boundaries served.

  The forward over the context is one CUDA graph (`StepGraph`, captured
  at the first call; `graphs=False` runs it eagerly): the history
  buffers are the graph's static inputs, so a step is the observation's
  two host-to-device copies into its slot (and, once T steps are held,
  the window's shift: two device copies of each buffer), one graph
  launch and the action's copy to the host. On the CPU the same forward
  runs eagerly over the same buffers.
  """

  def __init__(self, model: VRGripperTransformerModel, state: TrainState,
               context_length: int, device: DeviceLike = None,
               graphs: bool = True):
    device = resolve_device(device)
    self._device = device
    self._graphs = graphs
    self._graph: Optional[StepGraph] = None
    self._model = model
    self._state = state.to(device)
    self._t = context_length
    spec = model.get_feature_specification(Mode.PREDICT)
    self._image = torch.zeros((1, context_length) + spec.image.shape,
                              dtype=torch.uint8, device=device)
    self._pose = torch.zeros((1, context_length) + spec.gripper_pose.shape,
                             dtype=torch.float32, device=device)
    self._held = 0
    self.steps = 0
    self.resets = 0

  def reset(self) -> None:
    self._held = 0
    self._image.zero_()
    self._pose.zero_()
    self.resets += 1

  def __call__(self, features: Dict[str, np.ndarray]
               ) -> Dict[str, np.ndarray]:
    image = torch.from_numpy(np.ascontiguousarray(features["image"][0]))
    pose = torch.from_numpy(
        np.asarray(features["gripper_pose"][0], np.float32))
    if self._held == self._t:  # keep the latest T steps
      self._image[:, :-1] = self._image[:, 1:].clone()
      self._pose[:, :-1] = self._pose[:, 1:].clone()
      self._held -= 1
    self._image[0, self._held].copy_(image)
    self._pose[0, self._held].copy_(pose)
    self._held += 1
    self.steps += 1
    actions = self._forward()
    # The CURRENT step's action is at the last real history slot.
    return {ACTION: actions[:, self._held - 1].cpu().numpy()}

  def _forward(self) -> torch.Tensor:
    """Actions [1, T, A] over the whole history."""
    history = {"image": self._image, "gripper_pose": self._pose}
    if not self._graphs:
      return self._model.predict_step(self._state, history)[ACTION]
    if self._graph is None:
      model = self._model
      self._graph = StepGraph(
          lambda state, feats, gens: (
              state, model.predict_step(state, feats)[ACTION]),
          self._state, history, self._device, carries=False,
          own_carry=False)
      # From now on observations go straight into the graph's inputs.
      self._image = self._graph.inputs["image"]
      self._pose = self._graph.inputs["gripper_pose"]
    return self._graph.replay()
