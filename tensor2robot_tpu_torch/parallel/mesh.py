"""Device mesh over a process group: the `data`, `stage` and `seq` axes
(port of `parallel/mesh.py`).

The JAX package's mesh names axes over every device of a slice
(``data``, ``fsdp``, ``model``, ``seq``, ``expert``, ``stage``) and jits
steps over it. The port's mesh is the process group (`torch.distributed`,
`parallel.distributed`) times each process's one local device, and runs
two axes:

  * ``data``: a training step is one rank's shard of the global batch
    (`parallel.collectives.data_parallel` for `train_qtopt`; the pipeline
    sums its gradients over the data group);
  * ``stage``: the GPipe schedule of `parallel.pipeline` over the stage
    ring, each rank holding one stage's weights;
  * ``seq``: ring attention (`parallel.ring_attention`) over the seq
    ring, each rank holding one slice of the time axis inside attention.

A rank's coordinates follow JAX's row-major device order over the axes'
order: in ``{"data": D, "stage": S}`` rank r is at data r // S, stage
r % S (and in ``{"data": D, "seq": P}`` at data r // P, seq r % P). For
each axis the mesh carries the process group of the ranks that differ
from this one only along it (`Mesh.group`): the stage or seq ring (same
data index) and the data group (same stage or seq index). A mesh with
one axis uses the default group. `create_mesh` is collective when it makes
subgroups (every rank makes every group, in one order:
`distributed.new_subgroups`), and equal calls in one process return the
same mesh, so gin's two `@create_mesh()` references make the groups once
(ROADMAP trap 64).

Any other axis, more than one local device per process and
`shard_map_compat` raise, naming ROADMAP A11 rest.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch import config as gin

DATA_AXIS = "data"
STAGE_AXIS = "stage"
SEQ_AXIS = "seq"
_PORTED_AXES = (DATA_AXIS, STAGE_AXIS, SEQ_AXIS)

_A11 = ("(ROADMAP A11 rest: the port's mesh has the data, stage and seq "
        "axes only)")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
  """`world_size` processes × one local device each, over named axes.
  `shape` maps axis names to sizes, as `jax.sharding.Mesh.shape`;
  `coords` is this rank's index on each axis."""

  axis_names: Tuple[str, ...]
  shape: Dict[str, int]
  local_devices: Tuple[Any, ...]
  world_size: int
  rank: int
  coords: Dict[str, int] = dataclasses.field(default_factory=dict)
  groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

  @property
  def size(self) -> int:
    return int(np.prod(list(self.shape.values()))) if self.shape else 1

  def axis_size(self, axis: str) -> int:
    """The axis's size; 1 for an axis the mesh does not have."""
    return int(self.shape.get(axis, 1))

  def axis_index(self, axis: str) -> int:
    """This rank's index on `axis` (0 for an absent axis)."""
    return int(self.coords.get(axis, 0))

  def group(self, axis: str):
    """The process group of the ranks that differ from this one only
    along `axis` (None: the default group, for a one-axis mesh)."""
    return self.groups.get(axis)

  def axis_ranks(self, axis: str) -> Tuple[int, ...]:
    """The global ranks of this rank's `axis` group, in axis order."""
    return axis_ranks(self.axis_names, self.shape, self.rank, axis)


def axis_ranks(names: Sequence[str], shape: Dict[str, int], rank: int,
               axis: str) -> Tuple[int, ...]:
  """The global ranks that share `rank`'s coordinates on every axis but
  `axis`, ordered along it (row-major rank order over `names`)."""
  sizes = [shape[n] for n in names]
  coords = list(np.unravel_index(rank, sizes))
  i = list(names).index(axis)
  out = []
  for j in range(sizes[i]):
    coords[i] = j
    out.append(int(np.ravel_multi_index(coords, sizes)))
  return tuple(out)


# Equal calls in one process share one mesh (and its groups).
_MESHES: Dict[Tuple, Mesh] = {}


@gin.configurable
def create_mesh(
    axis_shapes: Optional[Dict[str, int]] = None,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
  """Builds the mesh over the process group.

  Args:
    axis_shapes: ordered {axis_name: size}; one axis may be -1 (absorbs
      the rest). Default: every device of the group on `data`. The
      `data`, `stage` and `seq` axes are ported.
    devices: this process's local devices; default its one device, as
      the trainer that computes on the mesh resolves it (its `device`
      argument: the card unless the CPU is asked for). The mesh's devices
      are the group's processes times these.
  """
  from tensor2robot_tpu_torch.parallel import collectives, distributed

  other = [n for n in (axis_shapes or {}) if n not in _PORTED_AXES]
  if other:
    raise NotImplementedError(f"mesh axes {other} {_A11}")
  devices = [None] if devices is None else list(devices)
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
  shape = dict(zip(names, sizes))
  rank = distributed.process_index()
  key = (tuple(shape.items()), tuple(str(d) for d in devices), world, rank)
  mesh = _MESHES.get(key)
  if mesh is None:
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    groups = {}
    if len(names) > 1 and world > 1:
      groups = distributed.new_subgroups(names, shape, rank)
    mesh = Mesh(axis_names=names, shape=shape, local_devices=tuple(devices),
                world_size=world, rank=rank, coords=coords, groups=groups)
    _MESHES[key] = mesh
  return mesh


def local_batch_size(mesh: Mesh, global_batch_size: int) -> int:
  """The rows of a global batch one rank holds: the batch divided by
  the `data` axis only (a `stage` or `seq` rank of a data row holds all
  of the row's examples); raises JAX's error when it does not divide."""
  shards = mesh.axis_size(DATA_AXIS)
  if global_batch_size % shards != 0:
    raise ValueError(
        f"Global batch {global_batch_size} not divisible by {shards} "
        f"data shards.")
  return global_batch_size // shards


def shard_map_compat(body, mesh: Mesh, *, in_specs, out_specs):
  """`shard_map` over a mesh: not ported."""
  raise NotImplementedError(f"shard_map_compat {_A11}")
