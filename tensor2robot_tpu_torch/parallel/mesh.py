"""Device mesh, its data axis only (port of `parallel/mesh.py`).

The JAX package's mesh names axes over every device of a slice
(``data``, ``fsdp``, ``model``, ``seq``, ``expert``, ``stage``) and jits
steps over it. The port runs the ``data`` axis: the mesh is the process
group (`torch.distributed`, `parallel.distributed`) times each process's
one local device, and a training step is one rank's shard of the global
batch inside `parallel.collectives.data_parallel` (every rank holds the
whole state). `train_qtopt` reads the mesh's size and rank; JAX's
sharding helpers (`replicated`, `batch_sharding`, `local_batch_size`)
have no reader in the port. Any other axis, more than one local device
per process and `shard_map_compat` raise, naming ROADMAP A11 rest.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch import config as gin

DATA_AXIS = "data"

_A11 = "(ROADMAP A11 rest: the port's mesh is the data axis only)"


@dataclasses.dataclass(frozen=True)
class Mesh:
  """A data-axis mesh: `world_size` processes × one local device each.
  `shape` maps axis names to sizes, as `jax.sharding.Mesh.shape`."""

  axis_names: Tuple[str, ...]
  shape: Dict[str, int]
  local_devices: Tuple[Any, ...]
  world_size: int
  rank: int

  @property
  def size(self) -> int:
    return int(np.prod(list(self.shape.values()))) if self.shape else 1


@gin.configurable
def create_mesh(
    axis_shapes: Optional[Dict[str, int]] = None,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
  """Builds the data-axis mesh over the process group.

  Args:
    axis_shapes: ordered {axis_name: size}; one axis may be -1 (absorbs
      the rest). Default: every device of the group on `data`. Only the
      `data` axis is ported.
    devices: this process's local devices; default its one device (the
      card, `device.resolve_device(None)`). The mesh's devices are the
      group's processes times these.
  """
  from tensor2robot_tpu_torch.parallel import collectives, distributed

  other = [n for n in (axis_shapes or {}) if n != DATA_AXIS]
  if other:
    raise NotImplementedError(f"mesh axes {other} {_A11}")
  if devices is None:
    from tensor2robot_tpu_torch.device import resolve_device
    devices = [resolve_device(None)]
  devices = list(devices)
  if len(devices) != 1:
    raise NotImplementedError(
        f"a mesh over {len(devices)} local devices of one process "
        f"{_A11}")
  world = collectives.group_size()
  n_devices = world * len(devices)
  if axis_shapes is None:
    axis_shapes = {DATA_AXIS: n_devices}
  names = tuple(axis_shapes.keys())
  sizes = list(axis_shapes.values())
  if sizes.count(-1) > 1:
    raise ValueError("At most one mesh axis may be -1.")
  if -1 in sizes:
    known = int(np.prod([s for s in sizes if s != -1]))
    if n_devices % known != 0:
      raise ValueError(
          f"Cannot infer -1 axis: {n_devices} devices not divisible by "
          f"{known}.")
    sizes[sizes.index(-1)] = n_devices // known
  if int(np.prod(sizes)) != n_devices:
    raise ValueError(
        f"Mesh {dict(zip(names, sizes))} needs {int(np.prod(sizes))} "
        f"devices, have {n_devices}.")
  return Mesh(axis_names=names, shape=dict(zip(names, sizes)),
              local_devices=tuple(devices), world_size=world,
              rank=distributed.process_index())


def shard_map_compat(body, mesh: Mesh, *, in_specs, out_specs):
  """`shard_map` over a mesh: not ported."""
  raise NotImplementedError(f"shard_map_compat {_A11}")
