"""The GPipe schedule over gloo stage ranks (`parallel/pipeline.py`,
`parallel/collectives.py`'s stage hops, `parallel/mesh.py`'s `stage`
axis, `parallel/sharding.py`) against the JAX package, on the CPU.

  * Eight spawned ranks (`tests/torch_pipeline_worker.py`, `data 2 ×
    stage 4`) run the trunk at `tests/test_pipeline_config.py`'s sizes
    (f32) on params converted from flax, each rank its stage and its
    data rows, without and with remat. Against JAX's `pipeline_apply` on
    the 8-device CPU mesh of the same shape (the pipelined trunk): the
    outputs and every gradient of sum(out · r), the stages gathered over
    the stage ring, within 1e-5 (of each leaf's largest |value| for
    gradients). The two data rows' ranks of a stage hold equal
    gradients; remat equals no remat.
  * `data_rows` is JAX's layout (trap 61) and raises JAX's error on an
    indivisible batch; `pipeline_apply` raises it on a rank's rows.
  * A `stage` axis of size 1, or none, is the sequential fallback.
  * The mesh: coordinates in JAX's row-major order, each axis's group's
    ranks, and one `create_mesh` object for equal calls (trap 64).
  * `state_sharding(..., "pipeline")` equals JAX's `pipeline_sharding`
    spec for spec (the stage-stacked leaves and their Adam mirrors on
    `stage`, the rest replicated); an indivisible leading dim raises as
    JAX's does; the other strategies raise naming A11 rest.
"""

import multiprocessing as mp
import queue as queue_lib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.layers.pipelined_transformer import (  # noqa: E402
    PipelinedCausalTransformer as JaxTrunk,
)
from tensor2robot_tpu.parallel import (  # noqa: E402
    create_mesh as jax_create_mesh,
)
from tensor2robot_tpu.parallel import (  # noqa: E402
    state_sharding as jax_state_sharding,
)
from tensor2robot_tpu_torch.layers.pipelined_transformer import (  # noqa: E402
    PipelinedCausalTransformer,
)
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.models.abstract_model import (  # noqa: E402
    init_parameters,
)
from tensor2robot_tpu_torch.models import optimizers as opt_lib  # noqa: E402
from tensor2robot_tpu_torch.parallel import distributed  # noqa: E402
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from tensor2robot_tpu_torch.parallel import pipeline, sharding  # noqa: E402
from tensor2robot_tpu_torch.parallel.rules import PartitionSpec  # noqa: E402

import torch_pipeline_worker as worker  # noqa: E402

_SHAPES = {"data": 2, "stage": 4}
_TIMEOUT = 240.0


def _spawn(target, ranks, *args):
  """Runs `target(address, world, rank, *args, out)` in `ranks` spawned
  processes; returns their queue items by rank. Every child is joined
  (killed past the time limit)."""
  ctx = mp.get_context("spawn")
  out = ctx.Queue()
  address = distributed.ephemeral_coordinator_address()
  procs = [ctx.Process(target=target, args=(address, ranks, r) + args
                       + (out,), daemon=True) for r in range(ranks)]
  for p in procs:
    p.start()
  items = {}
  try:
    for _ in procs:
      item = out.get(timeout=_TIMEOUT)
      items[item[0]] = item
  except queue_lib.Empty:
    raise AssertionError(
        f"ranks {sorted(set(range(ranks)) - set(items))} gave no result; "
        f"exit codes {[p.exitcode for p in procs]}") from None
  finally:
    for p in procs:
      p.join(timeout=30)
      if p.is_alive():
        p.kill()
        p.join()
  assert [p.exitcode for p in procs] == [0] * ranks
  return items


def _fake_mesh(shape, rank=0):
  names = tuple(shape)
  coords = dict(zip(names, (int(c) for c in np.unravel_index(
      rank, [shape[n] for n in names]))))
  return mesh_lib.Mesh(axis_names=names, shape=dict(shape),
                       local_devices=("cpu",), world_size=int(np.prod(list(
                           shape.values()))), rank=rank, coords=coords)


@pytest.fixture(scope="module")
def jax_pipelined():
  """JAX's trunk on the data 2 × stage 4 CPU mesh: its variables, the
  inputs, its output and the gradients of sum(out · r)."""
  sizes = {k: v for k, v in worker.TRUNK.items() if k != "in_features"}
  rng = np.random.default_rng(0)
  x = jnp.asarray(rng.standard_normal((8, 16, 8)), jnp.float32)
  r = jnp.asarray(rng.standard_normal((8, 16, sizes["width"])), jnp.float32)
  mesh = jax_create_mesh(dict(_SHAPES))
  trunk = JaxTrunk(**sizes, mesh=mesh, dtype=jnp.float32,
                   attention_impl="reference")
  variables = jax.jit(JaxTrunk(**sizes, mesh=None, dtype=jnp.float32,
                               attention_impl="reference").init)(
                                   jax.random.PRNGKey(0), x)
  out = trunk.apply(variables, x)
  grads = jax.grad(lambda v: jnp.sum(trunk.apply(v, x) * r))(variables)
  return (jax.device_get(variables), np.array(x), np.array(r),
          np.asarray(out), jax.device_get(grads))


def test_gloo_pipeline_equals_jax_pipeline_apply(jax_pipelined):
  variables, x, r, want_out, want_grads = jax_pipelined
  params = {k: v.numpy() for k, v in convert.convert_params(
      variables["params"]).items()}
  want = {k: v.numpy() for k, v in convert.convert_params(
      want_grads["params"]).items()}
  items = _spawn(worker.trunk_step, 8, _SHAPES, params, x, r)
  by_stage = {}
  for rank, (_, coords, rows, results) in items.items():
    assert coords == dict(zip(("data", "stage"), divmod(rank, 4)))
    np.testing.assert_array_equal(rows, pipeline.data_rows(8, 2, 2,
                                                           coords["data"]))
    by_stage.setdefault(coords["stage"], []).append(results)
  for remat in (False, True):
    out = np.zeros_like(want_out)
    for _, _, rows, results in items.values():
      out[rows] = results[remat][0]
    np.testing.assert_allclose(out, want_out, atol=1e-5, rtol=1e-5)
    for stage, (a, b) in by_stage.items():
      for k in a[remat][1]:
        np.testing.assert_array_equal(a[remat][1][k], b[remat][1][k])
    for k, g in want.items():
      if k.startswith("stages."):
        got = np.concatenate([by_stage[s][0][remat][1][k] for s in range(4)])
      else:
        got = by_stage[0][0][remat][1][k]
      err = float(np.abs(got - g).max()) / max(float(np.abs(g).max()), 1e-12)
      assert err <= 1e-5, (remat, k, err)
    if remat:
      for rank, (_, _, _, results) in items.items():
        np.testing.assert_allclose(results[True][0], results[False][0],
                                   atol=1e-6, rtol=1e-6)


def test_data_rows_are_jax_layout():
  np.testing.assert_array_equal(pipeline.data_rows(16, 2, 2, 0),
                                [0, 1, 2, 3, 8, 9, 10, 11])
  np.testing.assert_array_equal(pipeline.data_rows(16, 2, 2, 1),
                                [4, 5, 6, 7, 12, 13, 14, 15])
  np.testing.assert_array_equal(pipeline.data_rows(8, 2, 1, 0), range(8))
  with pytest.raises(ValueError, match=r"Batch 6 must be a multiple of "
                     r"num_microbatches=2 × data axis 2"):
    pipeline.data_rows(6, 2, 2, 0)


def test_pipeline_apply_raises_on_an_indivisible_batch():
  mesh = _fake_mesh(_SHAPES, rank=1)
  params = {"w": torch.zeros((1, 4))}
  with pytest.raises(ValueError, match=r"Batch 6 must be a multiple of "
                     r"num_microbatches=2 × data axis 2"):
    pipeline.pipeline_apply(lambda p, h: h, params, torch.zeros((3, 4)),
                            mesh=mesh, num_microbatches=2)


@pytest.mark.parametrize("shape", [None, {"data": 2}, {"stage": 1},
                                   {"data": 2, "stage": 1}])
def test_no_stage_axis_is_the_sequential_fallback(shape):
  mesh = None if shape is None else _fake_mesh(shape)
  params = {"w": torch.arange(1.0, 4.0)[:, None]}
  out = pipeline.pipeline_apply(lambda p, h: h * p["w"], params,
                                torch.ones((2, 1)), mesh=mesh,
                                num_microbatches=2)
  assert torch.equal(out, torch.full((2, 1), 6.0))


def test_mesh_coordinates_and_groups_follow_jax_order():
  names, shape = ("data", "stage"), dict(_SHAPES)
  jax_mesh = jax_create_mesh(dict(_SHAPES))
  ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
  for rank in range(8):
    d, s = divmod(rank, 4)
    assert ids[d, s] == rank
    assert mesh_lib.axis_ranks(names, shape, rank, "stage") == tuple(
        ids[d, :])
    assert mesh_lib.axis_ranks(names, shape, rank, "data") == tuple(
        ids[:, s])
  one = mesh_lib.create_mesh({"data": 1, "stage": 1}, devices=["cpu"])
  assert one is mesh_lib.create_mesh({"data": 1, "stage": 1},
                                     devices=["cpu"])
  assert one.coords == {"data": 0, "stage": 0} and not one.groups
  assert not pipeline.is_pipelined(one)
  with pytest.raises(NotImplementedError, match="A11 rest"):
    mesh_lib.create_mesh({"data": 1, "expert": 1}, devices=["cpu"])


def test_state_sharding_is_jax_pipeline_sharding():
  sizes = {k: v for k, v in worker.TRUNK.items() if k != "in_features"}
  x = jnp.zeros((2, 8, 8), jnp.float32)
  params = jax.jit(JaxTrunk(**sizes, mesh=None, dtype=jnp.float32,
                            attention_impl="reference").init)(
                                jax.random.PRNGKey(0), x)["params"]
  jax_mesh = jax_create_mesh(dict(_SHAPES))
  jax_specs = jax_state_sharding(jax_mesh, params, strategy="pipeline",
                                 min_size_to_shard=64)
  by_path = {"/".join(str(k.key) for k in path): tuple(sh.spec)
             for path, sh in jax.tree_util.tree_leaves_with_path(jax_specs)}
  trunk = PipelinedCausalTransformer(8, **sizes, dtype=torch.float32)
  init_parameters(trunk, torch.Generator().manual_seed(0))
  paths = convert.flax_param_paths(trunk)
  port_params = {k: v.detach() for k, v in trunk.named_parameters()}
  tx = opt_lib.create_optimizer()
  flat = {f"params/{k}": v for k, v in port_params.items()}
  adam = tx.init(port_params)[0]  # chain(scale_by_adam, learning rate)
  flat.update({f"opt_state/0/mu/{k}": v for k, v in adam.mu.items()})
  flat["opt_state/0/count"] = adam.count
  specs = sharding.state_sharding(_fake_mesh(_SHAPES), flat, "pipeline",
                                  min_size_to_shard=64)
  for name in port_params:
    assert tuple(specs[f"params/{name}"]) == by_path[paths[name]], name
    assert specs[f"opt_state/0/mu/{name}"] == specs[f"params/{name}"]
    stacked = name.startswith("stages.")
    assert (specs[f"params/{name}"] == PartitionSpec("stage")) == stacked
  assert specs["opt_state/0/count"] == PartitionSpec()
  sliced = sharding.shard_state(flat, _fake_mesh(_SHAPES, rank=6))
  for k, v in flat.items():
    want = v[2:3] if ".stages." in k or "/stages." in k else v
    assert torch.equal(sliced[k], want), k


def test_an_indivisible_stage_dim_raises_and_other_strategies_are_a11():
  mesh = _fake_mesh({"data": 1, "stage": 8})
  with pytest.raises(ValueError, match="not divisible"):
    sharding.state_sharding(mesh, {"params/stages.w": torch.zeros(4, 16)})
  jax_mesh = jax_create_mesh({"data": 1, "stage": 8})
  with pytest.raises(ValueError, match="not divisible"):
    jax_state_sharding(jax_mesh, {"stages": {"w": jnp.zeros((4, 16, 16))}},
                       strategy="pipeline")
  for strategy in ("fsdp", "tp", "ep"):
    with pytest.raises(NotImplementedError, match="A11 rest"):
      sharding.state_sharding(mesh, {"params/w": torch.zeros(4)}, strategy)


def test_init_stage_params_and_stage_sharding():
  """`init_stage_params` stacks S draws of one stage's init (stage-major
  from one generator); `stage_sharding` places every leaf's leading dim
  on `stage` (a scalar replicated), as JAX's."""
  calls = []

  def init(generator):
    calls.append(1)
    return {"w": torch.randn((2, 3), generator=generator),
            "b": torch.zeros(())}

  stacked = pipeline.init_stage_params(init, torch.Generator().manual_seed(0),
                                       4)
  assert len(calls) == 4 and stacked["w"].shape == (4, 2, 3)
  generator = torch.Generator().manual_seed(0)
  for s in range(4):
    assert torch.equal(stacked["w"][s], init(generator)["w"])
  specs = pipeline.stage_sharding(_fake_mesh(_SHAPES),
                                  {**stacked, "scalar": torch.zeros(())})
  assert specs["w"] == PartitionSpec("stage")
  assert specs["b"] == PartitionSpec("stage")  # leading [S] on a scalar
  assert specs["scalar"] == PartitionSpec()
