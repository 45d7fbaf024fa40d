"""Ring attention over a `seq` axis of gloo ranks
(`parallel/ring_attention.py`, the seq hops of `parallel/collectives.py`,
the `seq` axis of `parallel/mesh.py`) against the JAX package, on the
CPU.

  * Spawned ranks (`tests/torch_ring_worker.py`; `seq 4` and `data 2 ×
    seq 4`) run `ring_attention` on the full f32 q, k, v, causal and
    not, with reference and flash blocks (the plain flash version on the
    CPU). Against JAX's `ring_attention` on the 8-device CPU mesh of the
    same shape (flash blocks in Pallas interpret mode): every rank's
    output within 2e-5 of max|out|, and the gradients of sum(out · r) to
    q, k and v within 5e-5 of each leaf's largest |value|.
  * The same `data 2 × seq 4` ranks take one train step of the
    transformer with `attention_impl="ring"` and `"ring_flash"` against
    one process with `"reference"` and `"flash"` from the same params:
    f32 loss within 1e-5 relative, gradients within 1e-5 of each leaf's
    scale, post-Adam params within 1e-5 of the leaf's scale where |g| is
    not tiny (2·lr below); bf16 every gradient leaf's cosine ≥ 0.999; a
    data row's four seq ranks equal bit for bit.
  * The fallbacks are JAX's: no mesh or a seq axis of 1 is the
    reference; an indivisible T raises `ValueError`; a batch the data
    axis does not divide is replicated, silently at B = 1 and with a
    `RuntimeWarning` otherwise (checked in the ranks, and by
    `sequence_rows`); `MultiHeadAttention("ring" | "ring_flash")` builds
    and raises JAX's `ValueError` without a mesh.
"""

import multiprocessing as mp
import queue as queue_lib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.parallel import create_mesh as jax_create_mesh  # noqa: E402
from tensor2robot_tpu.parallel.ring_attention import (  # noqa: E402
    ring_attention as jax_ring_attention,
)
from tensor2robot_tpu_torch.layers import transformer  # noqa: E402
from tensor2robot_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
)
from tensor2robot_tpu_torch.parallel import distributed  # noqa: E402
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from tensor2robot_tpu_torch.parallel.ring_attention import (  # noqa: E402
    attention_reference,
    ring_attention,
    sequence_rows,
)
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    VRGripperTransformerModel,
)

import torch_ring_worker as worker  # noqa: E402

B, T, H, D = 4, 32, 2, 16
_MESHES = {"seq4": {"seq": 4}, "data2_seq4": {"data": 2, "seq": 4}}
_CASES = [(causal, impl) for causal in (False, True)
          for impl in ("reference", "flash")]
_TIMEOUT = 240.0
_LR = 1e-3


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


def _inputs(seed, batch=B):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal((batch, T, H, D)).astype(np.float32)
          for _ in range(4)]


def _ring_inputs():
  """Per case: q, k, v and the cotangent r, seeded."""
  return [_inputs(i) for i in range(len(_CASES))]


def _model_batch(seed=22):
  """8 episodes of 16 steps (lengths 4-16) for `worker.MODEL`."""
  rng = np.random.default_rng(seed)
  size, t = 8, worker.MODEL["max_context_length"]
  image = worker.MODEL["image_size"]
  features = {
      "image": rng.integers(0, 256, (size, t, image, image, 3),
                            dtype=np.uint8),
      "gripper_pose": rng.standard_normal((size, t, 3)).astype(np.float32),
      "sequence_length": rng.integers(4, t + 1, (size,)).astype(np.int64)}
  labels = {"action": rng.standard_normal((size, t, 3)).astype(np.float32)}
  return features, labels


def _model_params():
  model = VRGripperTransformerModel(device_dtype=torch.float32,
                                    attention_impl="reference",
                                    **worker.MODEL)
  return {k: v.numpy() for k, v in model.create_inference_state(
      seed=5, device="cpu").params.items()}


@pytest.fixture(scope="module")
def jax_rings():
  """JAX's ring on each mesh and case: (out, dq, dk, dv) of sum(out · r),
  flash blocks in interpret mode."""
  out = {}
  for name, shape in _MESHES.items():
    devices = jax.devices()[:int(np.prod(list(shape.values())))]
    mesh = jax_create_mesh(dict(shape), devices=devices)
    for (causal, impl), (q, k, v, r) in zip(_CASES, _ring_inputs()):

      def loss(q, k, v, causal=causal, impl=impl, r=r):
        y = jax_ring_attention(q, k, v, mesh=mesh, causal=causal,
                               block_impl=impl,
                               flash_interpret=impl == "flash")
        return jnp.sum(y * r), y

      (_, y), grads = jax.jit(jax.value_and_grad(
          loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
      out[(name, causal, impl)] = [np.asarray(y)] + [np.asarray(g)
                                                     for g in grads]
  return out


@pytest.fixture(scope="module")
def port_rings():
  """The port's ranks on each mesh: every case, and on `data 2 × seq 4`
  also a B = 3 and a B = 1 case (replicated over `data`) and the model
  steps."""
  params, batch = _model_params(), _model_batch()
  extra = [_inputs(40, batch=3), _inputs(41, batch=1)]
  out = {}
  for name, shape in _MESHES.items():
    ranks = int(np.prod(list(shape.values())))
    cases = [(q, k, v, r, causal, impl) for (causal, impl), (q, k, v, r)
             in zip(_CASES, _ring_inputs())]
    model_args = None
    if name == "data2_seq4":
      cases += [(q, k, v, r, True, "flash") for q, k, v, r in extra]
      model_args = (params, batch, ("ring", "ring_flash"),
                    ("float32", "bfloat16"))
    out[name] = _spawn(worker.ring_cases, ranks, shape, cases, model_args)
  return out, params, batch, extra


def _max_rel(got, want):
  return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                              1e-12)


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("causal,impl", _CASES)
def test_ring_equals_jax_ring_attention(jax_rings, port_rings, mesh, causal,
                                        impl):
  items = port_rings[0][mesh]
  want = jax_rings[(mesh, causal, impl)]
  index = _CASES.index((causal, impl))
  for rank, coords, results, _ in items.values():
    assert coords == dict(zip(_MESHES[mesh], np.unravel_index(
        rank, list(_MESHES[mesh].values()))))
    got = results[index]
    assert _max_rel(got[0], want[0]) <= 2e-5, (rank, "out")
    for name, g, w in zip("qkv", got[1:4], want[1:]):
      assert _max_rel(g, w) <= 5e-5, (rank, f"d{name}")
    assert got[4] == []


@pytest.mark.parametrize("batch,warns", [(3, True), (1, False)])
def test_an_indivisible_batch_is_replicated(port_rings, batch, warns):
  """B = 3 over `data 2` replicates the batch with JAX's warning; B = 1
  replicates it silently; both equal the reference."""
  items, _, _, extra = port_rings
  index = len(_CASES) + (0 if batch == 3 else 1)
  q, k, v, r = extra[index - len(_CASES)]
  leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
  y = attention_reference(*leaves, causal=True)
  (y * torch.from_numpy(r)).sum().backward()
  want = [y.detach().numpy()] + [x.grad.numpy() for x in leaves]
  for _, _, results, _ in items["data2_seq4"].values():
    got = results[index]
    assert _max_rel(got[0], want[0]) <= 2e-5
    for g, w in zip(got[1:4], want[1:]):
      assert _max_rel(g, w) <= 5e-5
    if warns:
      assert len(got[4]) == 1 and "does not divide" in got[4][0]
    else:
      assert got[4] == []


def _cosine(a, b):
  return float(np.dot(a.ravel(), b.ravel())
               / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("impl,single", [("ring", "reference"),
                                         ("ring_flash", "flash")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_train_step_on_the_ranks_equals_one_process(port_rings, impl,
                                                      single, dtype):
  items, params, batch, _ = port_rings
  ranks = items["data2_seq4"]
  one = worker.model_steps(None, params, batch, (single,), (dtype,))
  ref_grads, ref_params, ref_metrics = one[(single, dtype)]
  for row in (0, 1):
    seq_ranks = [r for r, item in ranks.items() if item[1]["data"] == row]
    first = ranks[seq_ranks[0]][3][(impl, dtype)]
    for r in seq_ranks[1:]:
      for a, b in zip(first, ranks[r][3][(impl, dtype)]):
        for key in a:
          np.testing.assert_array_equal(a[key], b[key], err_msg=key)
  grads, new_params, metrics = ranks[0][3][(impl, dtype)]
  if dtype == "bfloat16":
    cos = min(_cosine(grads[k], ref_grads[k]) for k in ref_grads
              if np.linalg.norm(ref_grads[k]) > 0)
    assert cos >= 0.999
    return
  scale = lambda x: max(float(np.abs(x).max()), 1e-12)  # noqa: E731
  assert abs(metrics["loss"] - ref_metrics["loss"]) <= 1e-5 * abs(
      ref_metrics["loss"])
  for k in ref_grads:
    assert np.abs(grads[k] - ref_grads[k]).max() <= 1e-5 * scale(
        ref_grads[k]), k
    small = np.abs(ref_grads[k]) < 1e-4 * scale(ref_grads[k])
    diff = np.abs(new_params[k] - ref_params[k])
    assert diff[~small].max(initial=0.0) <= 1e-5 * scale(ref_params[k]), k
    assert diff[small].max(initial=0.0) <= 2 * _LR + 1e-7, k


def _fake_mesh(shape, rank=0):
  names = tuple(shape)
  coords = dict(zip(names, (int(c) for c in np.unravel_index(
      rank, [shape[n] for n in names]))))
  return mesh_lib.Mesh(axis_names=names, shape=dict(shape),
                       local_devices=("cpu",), world_size=int(np.prod(list(
                           shape.values()))), rank=rank, coords=coords)


def test_single_device_fallbacks_and_the_indivisible_sequence():
  """No mesh, a seq axis of 1 or none is one device's attention: the
  reference for "reference" blocks (JAX's fallback), the flash wrapper
  for "flash" blocks (its plain version on a CPU tensor, the kernel on a
  CUDA one), within 2e-5 of max|out| of JAX's reference."""
  q, k, v, _ = [torch.from_numpy(x) for x in _inputs(7)]
  want = attention_reference(q, k, v, causal=True)
  want_flash = flash_attention(q, k, v, causal=True)
  for mesh in (None, _fake_mesh({"data": 1, "seq": 1}),
               _fake_mesh({"data": 1})):
    torch.testing.assert_close(
        ring_attention(q, k, v, mesh=mesh, causal=True), want,
        rtol=0, atol=0)
    torch.testing.assert_close(
        ring_attention(q, k, v, mesh=mesh, causal=True, block_impl="flash"),
        want_flash, rtol=0, atol=0)
  jax_want = np.asarray(jax_ring_attention(
      *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True))
  assert (np.abs(want_flash.numpy() - jax_want).max()
          <= 2e-5 * np.abs(jax_want).max())
  with pytest.raises(ValueError, match="must divide"):
    ring_attention(q[:, :30], k[:, :30], v[:, :30],
                   mesh=_fake_mesh({"seq": 4}))
  with pytest.raises(ValueError, match="Unknown block_impl"):
    ring_attention(q, k, v, mesh=_fake_mesh({"seq": 4}), block_impl="xla")


def test_sequence_rows_is_jax_sequence_sharding():
  """This rank's rows and T-slice under `P("data", "seq")`; an
  indivisible batch is every row, with the warning only where asked and
  only above B = 1."""
  mesh = _fake_mesh({"data": 2, "seq": 4}, rank=6)  # data 1, seq 2
  assert sequence_rows(mesh, 8, 32) == (slice(4, 8), slice(16, 24))
  assert sequence_rows(mesh, 8, 32, shard_batch=False) == (
      slice(0, 8), slice(16, 24))
  with warnings.catch_warnings():
    warnings.simplefilter("error")
    assert sequence_rows(mesh, 1, 32, warn=True)[0] == slice(0, 1)
    assert sequence_rows(mesh, 3, 32)[0] == slice(0, 3)
  with pytest.warns(RuntimeWarning, match="does not divide"):
    sequence_rows(mesh, 3, 32, warn=True)


def test_mesh_seq_axis_coordinates_and_local_batch():
  """JAX's `create_mesh({"data": 2, "seq": 4})` reshapes the devices to
  [2, 4]: rank = data·4 + seq; the batch divides by `data` only."""
  names, shape = ("data", "seq"), {"data": 2, "seq": 4}
  ids = np.arange(8).reshape(2, 4)
  for rank in range(8):
    d, s = divmod(rank, 4)
    assert mesh_lib.axis_ranks(names, shape, rank, "seq") == tuple(ids[d])
    assert mesh_lib.axis_ranks(names, shape, rank, "data") == tuple(
        ids[:, s])
  mesh = _fake_mesh(shape, rank=5)
  assert mesh.coords == {"data": 1, "seq": 1}
  assert mesh_lib.local_batch_size(mesh, 16) == 8
  with pytest.raises(ValueError, match="not divisible"):
    mesh_lib.local_batch_size(mesh, 7)
  one = mesh_lib.create_mesh({"data": 1, "seq": 1}, devices=["cpu"])
  assert one.coords == {"data": 0, "seq": 0} and not one.groups


@pytest.mark.parametrize("shape,strategy,runs", [
    ({"data": 2, "seq": 4}, "replicated", True),
    ({"data": 2, "seq": 4}, "fsdp", True),
    ({"data": 2, "seq": 4}, "tp", False),
    ({"data": 2, "stage": 4}, "replicated", False),
    ({"data": 2, "stage": 4}, "pipeline", True)])
def test_the_strategies_a_mesh_trains_with(shape, strategy, runs):
  """JAX's default "replicated" runs over a `data × seq` mesh, and so
  does "fsdp" (JAX's `ShardLargest` over no `fsdp` axis places
  nothing); a strategy that would place a shard, or "replicated" over
  stage ranks, raises naming A11 rest."""
  from tensor2robot_tpu_torch import train_eval
  mesh = _fake_mesh(shape)
  if runs:
    train_eval._check_unported(mesh, strategy,
                               train_eval._DEFAULT_MIN_SIZE_TO_SHARD)
  else:
    with pytest.raises(NotImplementedError, match="A11 rest"):
      train_eval._check_unported(mesh, strategy,
                                 train_eval._DEFAULT_MIN_SIZE_TO_SHARD)


def test_a_data_rank_draws_apart_and_a_seq_rank_alike():
  """`train_eval.draw_seed`, the seed of a model's generator: `seed + 1
  + step` without a mesh; the seq ranks of a data row alike (they
  compute the same rows), the data rows apart (other rows: JAX's one
  key draws apart for every row of the global batch)."""
  from tensor2robot_tpu_torch import train_eval
  assert train_eval.draw_seed(5, 3) == 9
  seeds = [train_eval.draw_seed(5, 3, _fake_mesh({"data": 2, "seq": 4},
                                                 rank=r)) for r in range(8)]
  assert seeds[:4] == [9] * 4
  assert len(set(seeds[4:])) == 1 and seeds[4] != 9
  masks = [torch.rand(64, generator=torch.Generator().manual_seed(x))
           for x in (seeds[0], seeds[4])]
  assert not torch.equal(*masks)


@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
def test_multi_head_attention_takes_the_ring(impl):
  """The layer builds with either ring impl (no parameter depends on
  it); without a mesh its forward raises JAX's error, and over a mesh
  with a seq axis of 1 it is one device's attention with the ring's
  blocks: "ring" on a CPU tensor the reference, "ring_flash" the flash
  wrapper."""
  layer = transformer.MultiHeadAttention(32, 2, 16, attention_impl=impl,
                                         dtype=torch.float32)
  x = torch.from_numpy(np.random.default_rng(3).standard_normal(
      (2, 8, 32)).astype(np.float32))
  with pytest.raises(ValueError, match="needs a device mesh"):
    layer(x)
  layer.mesh = _fake_mesh({"data": 1, "seq": 1})
  reference = transformer.MultiHeadAttention(
      32, 2, 16, attention_impl="flash" if impl == "ring_flash"
      else "reference", dtype=torch.float32)
  reference.load_state_dict(layer.state_dict())
  torch.testing.assert_close(layer(x), reference(x), rtol=0, atol=0)


_GIN = ("tensor2robot_tpu/research/vrgripper/configs/"
        "train_vrgripper_transformer.gin")
_RING = (
    "create_mesh.axis_shapes = {'data': 2, 'seq': 4}",
    "train_eval_model.mesh = @create_mesh()",
    "VRGripperTransformerModel.mesh = @create_mesh()",
    "VRGripperTransformerModel.attention_impl = 'ring'",
    "train_eval_model.device = 'cpu'",
    "train_eval_model.max_train_steps = 4",
    "train_eval_model.save_checkpoints_steps = 4",
    "train_eval_model.log_every_steps = 2",
    "train_eval_model.batch_size = 4",
    "train/TFRecordEpisodeInputGenerator.sequence_length = 8",
    "train/TFRecordEpisodeInputGenerator.batch_size = 4",
    "VRGripperTransformerModel.image_size = 16",
    "VRGripperTransformerModel.filters = (4,)",
    "VRGripperTransformerModel.embedding_size = 8",
    "VRGripperTransformerModel.width = 16",
    "VRGripperTransformerModel.depth = 2",
    "VRGripperTransformerModel.num_heads = 2",
    "VRGripperTransformerModel.max_context_length = 8",
)


def test_the_transformer_gin_trains_on_data_seq_ranks(tmp_path, capfd):
  """`train_vrgripper_transformer.gin` with the ring bound (JAX's default
  "replicated" strategy over `data 2 × seq 4`): the binary starts the 8
  ranks, the losses are finite, and the checkpoint in the one-device
  layout serves on the mesh-free model ("ring" runs "auto" there)."""
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.research.vrgripper import (
      collect_demo_episodes,
  )
  from tensor2robot_tpu_torch.telemetry.records import read_records
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib

  demos = collect_demo_episodes(str(tmp_path / "demos.tfrecord"),
                                num_episodes=8, image_size=16, seed=7)
  model_dir = str(tmp_path / "run")
  argv = ["--gin_configs", _GIN]
  for binding in (f"train_eval_model.model_dir = '{model_dir}'",
                  f"train/TFRecordEpisodeInputGenerator.file_patterns = "
                  f"'{demos}'") + _RING:
    argv += ["--gin_bindings", binding]
  assert run_t2r_trainer.main(argv) == 0
  out = capfd.readouterr().out
  assert '"world": 8' in out and "ranks exited: [0, 0, 0, 0, 0, 0, 0, 0]" in out
  records = read_records(f"{model_dir}/metrics_train.jsonl")
  assert [r["step"] for r in records] == [2, 4]
  assert all(np.isfinite(r["loss"]) for r in records)
  serving = VRGripperTransformerModel(
      image_size=16, filters=(4,), embedding_size=8, width=16, depth=2,
      num_heads=2, max_context_length=8, attention_impl="auto")
  state = serving.create_inference_state(0, device="cpu")
  variables = ckpt_lib.restore_variables(
      model_dir, like={"params": state.params, "batch_stats": {}})
  state = state.__class__(step=4, params=variables["params"],
                          batch_stats={})
  rng = np.random.default_rng(1)
  action = serving.predict_step(state, {
      "image": torch.from_numpy(rng.integers(0, 256, (2, 8, 16, 16, 3),
                                             dtype=np.uint8)),
      "gripper_pose": torch.from_numpy(rng.standard_normal(
          (2, 8, 3)).astype(np.float32))})["action"]
  assert action.shape == (2, 8, 3) and bool(torch.isfinite(action).all())
