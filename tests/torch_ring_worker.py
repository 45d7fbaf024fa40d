"""Seq ranks for tests/test_torch_ring_attention.py.

Spawned processes import torch and the port only (no JAX): each joins a
gloo group through `parallel.distributed.maybe_initialize_distributed`,
builds the mesh, runs its part and puts numpy results on a queue. One
intra-op thread in each.
"""

import numpy as np
import torch


def _join(address, world, rank, axis_shapes):
  torch.set_num_threads(1)
  from tensor2robot_tpu_torch.parallel import distributed, mesh as mesh_lib

  if not distributed.maybe_initialize_distributed(address, world, rank):
    raise AssertionError(f"rank {rank} joined no group")
  return mesh_lib.create_mesh(axis_shapes, devices=["cpu"])


def ring_cases(address, world, rank, axis_shapes, cases, model_args,
               out):
  """`ring_attention` on every case: (q, k, v, the cotangent, causal,
  block_impl), the full f32 arrays on every rank; then, with
  `model_args`, `model_steps` on the same mesh. Puts (rank,
  coords, [(out, dq, dk, dv, the warnings' messages)], the model steps'
  results or None) with the gradients of sum(out · cotangent)."""
  import warnings

  from tensor2robot_tpu_torch.parallel.ring_attention import ring_attention

  mesh = _join(address, world, rank, axis_shapes)
  results = []
  for q, k, v, ct, causal, block_impl in cases:
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")
      y = ring_attention(*leaves, mesh=mesh, causal=causal,
                         block_impl=block_impl)
    (y * torch.from_numpy(ct)).sum().backward()
    results.append((y.detach().numpy(),)
                   + tuple(x.grad.numpy() for x in leaves)
                   + ([str(w.message) for w in caught],))
  steps = model_steps(mesh, *model_args) if model_args else None
  out.put((rank, dict(mesh.coords), results, steps))
  torch.distributed.destroy_process_group()


MODEL = dict(image_size=16, filters=(8,), embedding_size=16, width=32,
             depth=2, num_heads=2, max_context_length=16)


def model_steps(mesh, params, batch, impls, dtypes):
  """One train step of the transformer (`MODEL`) for each attention impl
  and dtype from the one-device `params`, on this rank's data rows of
  the global `batch` (`mesh` None: one process, the whole batch).
  Returns {(impl, dtype): (grads, new params, metrics)} as numpy."""
  import dataclasses

  from tensor2robot_tpu_torch.models import optimizers as opt_lib
  from tensor2robot_tpu_torch.parallel import pipeline
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
  )

  features, labels = batch
  size = len(labels["action"])
  rows = np.arange(size)
  if mesh is not None:
    rows = pipeline.data_rows(size, 1, mesh.axis_size("data"),
                              mesh.axis_index("data"))
  host = lambda d: {k: v.detach().float().numpy()  # noqa: E731
                    for k, v in d.items()}
  results = {}
  for impl in impls:
    for name in dtypes:
      model = VRGripperTransformerModel(
          mesh=mesh, attention_impl=impl, device_dtype=getattr(torch, name),
          create_optimizer_fn=lambda: opt_lib.create_optimizer(
              learning_rate=1e-3), **MODEL)
      like = model.create_inference_state(seed=0, device="cpu")
      leaves = {k: torch.from_numpy(params[k]) for k in like.params}
      state = dataclasses.replace(like, params=leaves,
                                  opt_state=model.tx.init(leaves))
      f = {k: torch.from_numpy(v[rows]) for k, v in features.items()}
      lab = {k: torch.from_numpy(v[rows]) for k, v in labels.items()}
      grads, stats, metrics = model.train_grads(state, f, lab)
      new = model.apply_gradients(state, grads, stats)
      results[(impl, name)] = (host(grads), host(new.params), host(metrics))
  return results
