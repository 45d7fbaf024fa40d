"""Carries flax variables across into the port's state (every family).

`convert_variables` takes what the JAX package's network holds —
``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (``jax.device_get`` of a flax variables tree) — and returns a
`TrainState` whose keys are the port network's parameter/buffer names.
Port modules mirror the flax module paths (``trunk.block0.attn.qkv``,
``scene_tower.trunk.stage0_block0.film.film_proj``), so the mapping is
mechanical, for every family (Q-networks, the transformer, pose_env,
grasp2vec's `ResNet` towers with their FiLM layers, the MDN head's
``mdn_proj``, SNAIL's ``query``/``key``/``value`` and causal convs, and
MAML's base network under ``base_net`` beside its scalar
``inner_lr_log``):

  * conv kernel HWIO → torch OIHW ``<name>.weight``; a 1D conv's
    (SNAIL's causal convs) ``[k, in, out]`` → ``[out, in, k]``;
  * Dense kernel ``[in, out]`` → Linear ``[out, in]`` ``<name>.weight``;
  * biases map one to one (a conv has one only without batch norm, as
    grasp2vec's 1×1 ``embed``);
  * ``scale`` of a module with batch statistics (BatchNorm) stays
    ``scale``, its ``mean``/``var`` stats map one to one (eps 1e-5 in
    both networks); ``scale`` of any other module (LayerNorm) becomes
    torch's ``weight``;
  * a pipelined trunk's ``stages`` leaves (a leading stage dim) convert
    per stage, the stage dim kept in front (``[S, in, out]`` kernels →
    ``[S, out, in]``);
  * raw params (``trunk.positions``, ``...ssoftmax.log_temperature``,
    ``inner_lr_log``) and the MoE layer's ``router`` and
    ``moe_expert_{w_in,b_in,w_out,b_out}`` (stored in the einsum layout
    in both packages, so not transposed) are carried as they are.

`flax_param_paths` is the map's inverse on names: each port param's
'/'-joined flax path, which the sharding rules tables read
(`parallel.rules`).

A name the port network does not have fails when the state is bound
(`AbstractT2RModel.bind` loads strictly).

Leaves come out float32 (the port's master dtype). A bfloat16 numpy
leaf (an `ml_dtypes` array) is read through its uint16 view, so this
module needs no `ml_dtypes` import.
"""

from __future__ import annotations

from typing import Any, Collection, Dict, Mapping

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.models.abstract_model import TrainState


def to_tensor(leaf: Any) -> torch.Tensor:
  """numpy (incl. bfloat16) → float32 torch tensor on the CPU."""
  arr = np.asarray(leaf)
  if arr.dtype.name == "bfloat16":
    bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16))
    return bits.view(torch.bfloat16).float()
  return torch.from_numpy(np.array(arr, dtype=np.float32))


def _walk(tree: Mapping[str, Any], prefix: str = ""):
  """Yields (dotted module path, {leaf name: array}) per flax module."""
  leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
  if leaves:
    yield prefix, leaves
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _walk(value, f"{prefix}.{key}" if prefix else key)


# flax kernel → torch weight: HWIO → OIHW; [k, in, out] → [out, in, k];
# [in, out] → [out, in].
_KERNEL_ORDER = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}
# `layers.pipelined_transformer.STAGE_PARAMS_NAME`.
_STAGES = "stages"


def convert_params(params: Mapping[str, Any],
                   stats_modules: Collection[str] = ()
                   ) -> Dict[str, torch.Tensor]:
  """`stats_modules`: module paths that hold batch statistics."""
  out = {}
  for module, leaves in _walk(params):
    # A pipelined trunk's `stages` leaves carry a leading stage dim: each
    # stage's slice converts as the leaf of one module.
    lead = 1 if _STAGES in module.split(".") else 0
    for name, leaf in leaves.items():
      t = to_tensor(leaf)
      if name == "kernel":
        rank = t.ndim - lead
        if rank not in _KERNEL_ORDER:
          raise ValueError(f"{module}.kernel has rank {rank}")
        t = t.permute(tuple(range(lead)) + tuple(
            lead + i for i in _KERNEL_ORDER[rank]))
        name = "weight"
      elif name == "scale" and module not in stats_modules:
        name = "weight"      # LayerNorm
      key = f"{module}.{name}" if module else name
      out[key] = t.contiguous()
  return out


def convert_batch_stats(stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  out = {}
  for module, leaves in _walk(stats):
    for name, leaf in leaves.items():
      if name not in ("mean", "var"):
        raise ValueError(f"unexpected flax batch stat {module}.{name}")
      out[f"{module}.{name}"] = to_tensor(leaf).contiguous()
  return out


def convert_variables(variables: Mapping[str, Any],
                      step: int = 0) -> TrainState:
  """flax ``{"params", "batch_stats"}`` (numpy) → port `TrainState`."""
  stats = variables.get("batch_stats", {})
  return TrainState(
      step=step,
      params=convert_params(variables["params"],
                            {module for module, _ in _walk(stats)}),
      batch_stats=convert_batch_stats(stats))


_FLAX_KERNEL_ORDER = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _flax_leaves(network: nn.Module):
  """Yields (port name, flax path, flax shape) of each parameter."""
  modules = dict(network.named_modules())
  for name, param in network.named_parameters():
    module_path, _, leaf = name.rpartition(".")
    shape = tuple(param.shape)
    if leaf == "weight" and isinstance(modules[module_path], (
        nn.Linear, nn.Conv1d, nn.Conv2d)):
      leaf = "kernel"
      lead = 1 if getattr(modules[module_path], "stage_stacked",
                          False) else 0
      shape = shape[:lead] + tuple(
          shape[lead + i] for i in _FLAX_KERNEL_ORDER[len(shape) - lead])
    elif leaf == "weight":
      leaf = "scale"
    path = module_path.split(".") + [leaf] if module_path else [leaf]
    yield name, "/".join(path), shape


def flax_param_paths(network: nn.Module) -> Dict[str, str]:
  """{port param name: '/'-joined flax param path} for `network`'s
  parameters: the module path's dots become slashes, a Linear's or a
  conv's ``weight`` is flax's ``kernel``, any other module's ``weight``
  (the LayerNorm's) is flax's ``scale``, and every other leaf name is
  the flax one."""
  return {name: path for name, path, _ in _flax_leaves(network)}


def flax_param_shapes(network: nn.Module) -> Dict[str, tuple]:
  """{port param name: the flax param's shape}: kernels in flax's layout
  (``[in, out]``, HWIO, ``[k, in, out]``), every other leaf as it is."""
  return {name: shape for name, _, shape in _flax_leaves(network)}
