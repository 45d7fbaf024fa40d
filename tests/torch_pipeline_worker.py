"""Pipeline stage ranks for tests/test_torch_pipeline.py and
tests/test_torch_pipeline_config.py.

Spawned processes import torch and the port only (no JAX): each joins a
gloo group through `parallel.distributed.maybe_initialize_distributed`,
builds the mesh, runs its part and puts numpy results on a queue. One
intra-op thread in each.
"""

import os

import numpy as np
import torch

TRUNK = dict(in_features=8, width=32, depth=4, num_heads=2, max_len=16,
             num_stages=4, num_microbatches=2)


def _join(address, world, rank, axis_shapes):
  torch.set_num_threads(1)
  from tensor2robot_tpu_torch.parallel import distributed, mesh as mesh_lib

  if not distributed.maybe_initialize_distributed(address, world, rank):
    raise AssertionError(f"rank {rank} joined no group")
  mesh = mesh_lib.create_mesh(axis_shapes, devices=["cpu"])
  again = mesh_lib.create_mesh(dict(axis_shapes), devices=["cpu"])
  assert again is mesh, "equal create_mesh calls must share one mesh"
  return mesh


def trunk_step(address, world, rank, axis_shapes, params, x, r, out):
  """The trunk (`TRUNK`, f32) on this rank's data rows of `x` over the
  mesh, its stage's slice of the one-device `params`, without and with
  remat: the rows' outputs and the gradients of sum(out · r) over the
  global batch (this rank's rows' share, summed over the data group).
  Puts (rank, coords, rows, {remat: (outputs, grads)})."""
  from tensor2robot_tpu_torch.layers.pipelined_transformer import (
      PipelinedCausalTransformer,
  )
  from tensor2robot_tpu_torch.parallel import collectives, pipeline
  from tensor2robot_tpu_torch.parallel import sharding

  mesh = _join(address, world, rank, axis_shapes)
  rows = pipeline.data_rows(x.shape[0], TRUNK["num_microbatches"],
                            mesh.axis_size("data"), mesh.axis_index("data"))
  local = sharding.shard_state(
      {k: torch.from_numpy(v) for k, v in params.items()}, mesh)
  results = {}
  for remat in (False, True):
    with torch.device("meta"):
      trunk = PipelinedCausalTransformer(
          **TRUNK, remat=remat, attention_impl="reference", mesh=mesh,
          dtype=torch.float32)
    leaves = {k: v.clone().requires_grad_() for k, v in local.items()}
    y = torch.func.functional_call(trunk, leaves,
                                   (torch.from_numpy(x[rows]),))
    (y * torch.from_numpy(r[rows])).sum().backward()
    grads = {k: v.grad for k, v in leaves.items()}
    if mesh.axis_size("data") > 1:
      grads = collectives.all_reduce_sum_dict(grads, mesh.group("data"))
    results[remat] = (y.detach().numpy(),
                      {k: v.numpy() for k, v in grads.items()})
  out.put((rank, dict(mesh.coords), rows, results))
  torch.distributed.destroy_process_group()


MODEL = dict(image_size=24, filters=(8,), embedding_size=16, width=32,
             depth=4, num_heads=2, max_context_length=64,
             attention_impl="reference", pipeline_stages=2,
             pipeline_microbatches=2)


def train_run(address, world, rank, axis_shapes, model_dir, batches, steps,
              k, out):
  """`train_eval_model` as rank `rank` over the mesh (`world` 0: one
  process, no mesh) on the tiny pipelined model (`MODEL`, f32) and
  `batches` (a list of global (features, labels) numpy batches, in
  order, repeated). Then the trained state's forward on the first
  batch's features (this rank's data rows). Puts (rank, coords, rows,
  predictions, the state's step)."""
  from tensor2robot_tpu_torch import train_eval
  from tensor2robot_tpu_torch.data.abstract_input_generator import (
      AbstractInputGenerator,
  )
  from tensor2robot_tpu_torch.models import optimizers as opt_lib
  from tensor2robot_tpu_torch.parallel import pipeline
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
  )

  class Batches(AbstractInputGenerator):

    def _create_dataset(self, mode, batch_size):
      while True:
        yield from batches

    def create_dataset(self, mode, batch_size=None):
      return self._create_dataset(mode, batch_size)

  mesh = None
  if world:
    mesh = _join(address, world, rank, axis_shapes)
  else:
    torch.set_num_threads(1)
  model = VRGripperTransformerModel(
      mesh=mesh, device_dtype=torch.float32,
      create_optimizer_fn=lambda: opt_lib.create_optimizer(
          learning_rate=1e-3), **MODEL)
  batch = len(batches[0][1]["action"])
  state = train_eval.train_eval_model(
      model=model, model_dir=model_dir, input_generator_train=Batches(),
      max_train_steps=steps, save_checkpoints_steps=2 * k,
      log_every_steps=k, batch_size=batch, init_batch_size=8, mesh=mesh,
      sharding_strategy="pipeline", steps_per_dispatch=k, device="cpu")
  rows = np.arange(batch)
  if mesh is not None:
    rows = pipeline.data_rows(batch, model.pipeline_microbatches,
                              mesh.axis_size("data"),
                              mesh.axis_index("data"))
  features = {key: torch.from_numpy(v[rows])
              for key, v in batches[0][0].items()}
  predictions = model.predict_step(state, features)["action"]
  out.put((rank, dict(mesh.coords) if mesh else {}, rows,
           predictions.numpy(), int(state.step)))
  if world:
    torch.distributed.destroy_process_group()


def skewed_run(address, world, rank, axis_shapes, model_dir, batches, out):
  """`train_run` for 2 steps where each rank's generator starts the cycle
  of `batches` at its own rank, so the ranks read different global
  batches. Puts (rank, the ValueError's message)."""
  try:
    train_run(address, world, rank, axis_shapes, model_dir,
              batches[rank:] + batches[:rank], 2, 1, out)
  except ValueError as e:
    out.put((rank, str(e)))
