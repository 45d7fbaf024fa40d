"""The learner group over `torch.distributed` (gloo) against the JAX
package's one-process step, on the CPU.

  * `ephemeral_coordinator_address` and `maybe_initialize_distributed`:
    the address's form, no group for one process, idempotent in a group.
  * A spawned 2-rank gloo group takes one Bellman step, each rank on 8 of
    the 16 rows (`tests/torch_group_worker.py`), with the CEM noise of
    JAX's step injected (each rank its rows of it), inside
    `collectives.data_parallel`: batch norm over the global batch, the
    gradients and metrics averaged over the group. It equals the JAX
    learner's one-process step on the 16 rows: the loss and metrics,
    the gradients, the new params, Adam moments and target, and the new
    batch statistics, at `tests/test_torch_qtopt_train.py`'s f32
    tolerances (the same math in other summation orders: metrics 1e-5
    relative; gradients 1e-4 of each leaf's largest |value|; params 2e-6
    absolute, or 2·lr where the gradient is below 1e-4 of its leaf's
    largest; the target τ times that plus 1e-7; batch statistics 1e-5
    relative + 1e-6). bf16, against the port's one-process step on the
    16 rows (JAX's bf16 step is 0.977 away in one gradient's direction
    from the port's one-process step there): each gradient's direction
    (cosine ≥ 0.99) and the metrics to 2e-2 relative. Both ranks' new
    states are equal bit for bit.
  * `train_qtopt` in a 2-rank group: both ranks end bit for bit equal,
    and rank 1 writes no file (the chief owns checkpoints, the metric log
    and the sentinel; JAX's rank 1 joins orbax's collective save, the
    port's writes nothing). At world size 1 the group path is the single
    learner, bit for bit.
  * `learner_group_plan` and the data-axis mesh.
"""

import functools
import json
import multiprocessing as mp
import queue as queue_lib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu import specs as jax_specs  # noqa: E402
from tensor2robot_tpu.fleet.learner import (  # noqa: E402
    learner_group_plan as jax_learner_group_plan,
)
from tensor2robot_tpu.parallel import distributed as jax_distributed  # noqa: E402
from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    GraspingQModel as JaxGraspingQModel,
)
from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    QTOptLearner as JaxLearner,
)
from tensor2robot_tpu_torch.fleet import FleetConfig  # noqa: E402
from tensor2robot_tpu_torch.fleet.learner import learner_group_plan  # noqa: E402
from tensor2robot_tpu_torch.models import TrainState, convert  # noqa: E402
from tensor2robot_tpu_torch.models import optimizers  # noqa: E402
from tensor2robot_tpu_torch.parallel import collectives  # noqa: E402
from tensor2robot_tpu_torch.parallel import distributed  # noqa: E402
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt.qtopt_learner import (  # noqa: E402
    QTOptState,
)

import torch_group_worker as worker  # noqa: E402

_LR = 1e-4
_ROWS = 16
_METRICS = {"loss", "grad_norm", "q_loss", "q_mean", "target_q_mean",
            "q_next_mean", "target_mean"}
_TIMEOUT = 240.0


def _spawn(target, ranks, *args):
  """Runs `target(address, world, rank, ...)` in `ranks` spawned
  processes; returns their queue items by rank. Every child is joined
  (killed past the time limit)."""
  ctx = mp.get_context("spawn")
  out = ctx.Queue()
  address = distributed.ephemeral_coordinator_address()
  procs = [ctx.Process(target=target,
                       args=(address, ranks, r) + tuple(a[r] for a in args)
                       + (out,), daemon=True)
           for r in range(ranks)]
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


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
  got, want = _np(got), _np(want)
  assert got.shape == want.shape
  np.testing.assert_allclose(
      got, want, atol=tol * max(1e-12, float(np.abs(want).max())), rtol=0)


# ---- the launch contract ----


def test_ephemeral_coordinator_address_is_jax_form():
  for fn in (distributed.ephemeral_coordinator_address,
             jax_distributed.ephemeral_coordinator_address):
    address = fn()
    host, port = address.rsplit(":", 1)
    assert host == "127.0.0.1" and 0 < int(port) < 65536
  assert re.fullmatch(r"localhost:\d+",
                      distributed.ephemeral_coordinator_address("localhost"))


def test_one_process_initializes_no_group(monkeypatch):
  for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
    monkeypatch.delenv(var, raising=False)
  assert distributed.maybe_initialize_distributed() is False
  address = distributed.ephemeral_coordinator_address()
  assert distributed.maybe_initialize_distributed(address, 1, 0) is False
  monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
  monkeypatch.setenv("MASTER_PORT", address.rsplit(":", 1)[1])
  monkeypatch.setenv("WORLD_SIZE", "1")
  assert distributed.maybe_initialize_distributed() is False
  assert not torch.distributed.is_initialized()
  assert collectives.group_size() == 1 and distributed.process_index() == 0
  with collectives.data_parallel() as group:
    assert group is None and collectives.active_group() is None
  monkeypatch.delenv("RANK", raising=False)
  with pytest.raises(ValueError, match="needs a process id"):
    distributed.maybe_initialize_distributed(address, 2)


# ---- one Bellman step: the group against JAX's global step ----


@functools.lru_cache(maxsize=None)
def _jax_side(dtype):
  model = JaxGraspingQModel(device_dtype=dtype, **worker.VERIFY)
  learner = JaxLearner(model, cem_select="lax", **worker.CEM)
  state = jax.jit(functools.partial(learner.create_state, batch_size=2))(
      jax.random.PRNGKey(0))
  return (learner, jax.jit(learner.train_grads),
          jax.jit(learner.apply_gradients), state)


def _port_state(jax_state) -> QTOptState:
  ts = jax_state.train_state
  stats = jax.device_get(ts.batch_stats)
  modules = {m for m, _ in convert._walk(stats)}
  tree = lambda t: convert.convert_params(  # noqa: E731
      jax.device_get(t), modules)
  adam = ts.opt_state[0]
  return QTOptState(
      train_state=TrainState(
          step=int(ts.step), params=tree(ts.params),
          batch_stats=convert.convert_batch_stats(stats),
          opt_state=(optimizers.ScaleByAdamState(
              torch.tensor(int(adam.count), dtype=torch.int32),
              tree(adam.mu), tree(adam.nu)), optimizers.EmptyState())),
      target_params=tree(jax_state.target_params))


def _jax_noise(rng, batch):
  keys = jax.random.split(jax.random.split(rng)[0], 1)
  return torch.from_numpy(np.stack([
      np.asarray(jax.random.normal(k, (batch, 8, 2))) for k in keys]))


@pytest.fixture(scope="module")
def group_steps():
  """JAX's one-process step on 16 rows and the 2-rank group's, per
  dtype: {dtype: (JAX grads, JAX new state, JAX metrics, [rank 0's,
  rank 1's] (grads, new state, metrics), initialized flags, distinct
  devices)}."""
  dtypes = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
  want, jobs = {}, [[], []]
  for name, jdt in dtypes.items():
    learner, grads_fn, apply_fn, jax_state = _jax_side(jdt)
    batch = jax_specs.make_random_tensors(
        learner.transition_specification(), batch_size=_ROWS, seed=5)
    rng = jax.random.PRNGKey(3)
    state = _port_state(jax_state)
    flat = {k: np.array(v) for k, v in batch.to_flat_dict().items()}
    noise = _jax_noise(rng, _ROWS)
    if name == "float32":
      j_grads, j_stats, j_metrics = grads_fn(
          jax_state, jax.tree_util.tree_map(jnp.asarray, batch), rng)
      j_new = apply_fn(jax_state, j_grads, j_stats)
      modules = {m for m, _ in convert._walk(jax.device_get(j_stats))}
      want[name] = (convert.convert_params(jax.device_get(j_grads), modules),
                    worker.state_numpy(_port_state(j_new)),
                    {k: _np(v) for k, v in j_metrics.items()})
    else:
      # The port's one-process step on the global batch.
      grads, _, metrics = worker._learner(torch.bfloat16).train_grads(
          state, {k: torch.from_numpy(v) for k, v in flat.items()},
          noise=noise)
      want[name] = (grads, None, {k: _np(v) for k, v in metrics.items()})
    half = _ROWS // 2
    for r in range(2):
      rows = slice(r * half, (r + 1) * half)
      jobs[r].append((name, state,
                      {k: torch.from_numpy(v[rows]) for k, v in flat.items()},
                      noise[:, rows].contiguous()))
  items = _spawn(worker.group_step, 2, jobs)
  return {name: want[name] + ([items[r][2][i] for r in range(2)],
                              [items[r][1] for r in range(2)],
                              [items[r][3] for r in range(2)])
          for i, name in enumerate(dtypes)}


def test_group_is_initialized_once_and_idempotent(group_steps):
  for flags in group_steps["float32"][4]:
    assert flags == (True, True)


def test_ranks_sharing_a_device_span_one_device(group_steps):
  # `perf.mfu` divides by the peak of the devices the group spans: two
  # ranks on one device share its peak.
  assert group_steps["float32"][5] == [1, 1]
  assert collectives.distinct_devices("cpu") == 1  # no group


def test_group_step_equals_jax_global_step_f32(group_steps):
  want_grads, want_state, want_metrics, ranks = group_steps["float32"][:4]
  grads, new, metrics = ranks[0]
  assert set(metrics) == set(want_metrics) == _METRICS
  for key in _METRICS:
    np.testing.assert_allclose(metrics[key], want_metrics[key], rtol=1e-5,
                               err_msg=key)
  assert set(grads) == set(want_grads)
  for key, g in grads.items():
    _close(g, want_grads[key], 1e-4)
  assert set(new) == set(want_state)
  for key, value in new.items():
    want = want_state[key]
    if key.startswith("train_state/batch_stats/"):
      np.testing.assert_allclose(value, want, rtol=1e-5, atol=1e-6,
                                 err_msg=key)
    elif key.startswith(("train_state/params/", "target_params/")):
      name = key.split("/", 2)[-1] if key.startswith("train") else \
          key.split("/", 1)[1]
      g = np.abs(_np(grads[name]))
      tiny = g < 1e-4 * g.max()
      scale = 1.0 if key.startswith("train") else 0.05
      diff = np.abs(value - want)
      assert diff[~tiny].max(initial=0) <= scale * 2e-6 + 1e-7, key
      assert diff[tiny].max(initial=0) <= scale * 2 * _LR + 1e-7, key
    else:
      assert value.shape == np.shape(want), key
  assert int(new["train_state/step"]) == 1


def test_group_step_equals_the_global_step_bf16(group_steps):
  """bf16 against the port's one-process step on the same 16 rows and
  noise: JAX's bf16 step is no reference at this batch (the port's own
  one-process step points its `torso_bn_0.bias` gradient at cosine
  0.977 from JAX's: the frameworks round to bf16 at other places inside
  a conv), so the group is held to the global step it reproduces."""
  want_grads, _, want_metrics, ranks = group_steps["bfloat16"][:4]
  grads, _, metrics = ranks[0]
  for key in ("loss", "q_next_mean", "target_mean"):
    np.testing.assert_allclose(metrics[key], want_metrics[key], rtol=2e-2,
                               err_msg=key)
  for key, g in grads.items():
    w = torch.from_numpy(_np(want_grads[key])).flatten()
    cosine = torch.nn.functional.cosine_similarity(
        torch.from_numpy(g).flatten(), w, dim=0)
    assert cosine >= 0.99, (key, float(cosine))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_both_ranks_step_to_the_same_state_bit_for_bit(group_steps, dtype):
  (g0, s0, m0), (g1, s1, m1) = group_steps[dtype][3]
  for a, b in ((g0, g1), (s0, s1), (m0, m1)):
    assert set(a) == set(b)
    for key in a:
      np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_group_noise_is_the_global_draw_split():
  """A rank's CEM noise is its rows of the one-process draw on the global
  batch, and `cem.draw_noise` is what `cem_maximize` draws itself."""
  from tensor2robot_tpu_torch.research.qtopt import cem
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import (
      group_noise,
      step_generator,
  )
  learner = worker._learner(torch.float32)
  device = torch.device("cpu")
  ranks = [group_noise(learner, step_generator(0, 5, device), 8, r, 2)
           for r in range(2)]
  whole = cem.draw_noise(step_generator(0, 5, device), 1, 16, 8, 2)
  assert torch.equal(torch.cat(ranks, dim=1), whole)
  score = lambda a: -(a - 0.3).pow(2).sum(-1)  # noqa: E731
  kwargs = dict(iterations=2, population=8, num_elites=2)
  drawn = cem.cem_maximize(score, 16, 2, generator=step_generator(
      0, 5, device), **kwargs)
  given = cem.cem_maximize(score, 16, 2, noise=cem.draw_noise(
      step_generator(0, 5, device), 2, 16, 8, 2), **kwargs)
  assert torch.equal(drawn.best_action, given.best_action)
  assert torch.equal(drawn.best_score, given.best_score)


# ---- the loop ----


def test_train_qtopt_group_ranks_agree_and_rank1_writes_nothing(tmp_path):
  dirs = [str(tmp_path / "rank0"), str(tmp_path / "rank1")]
  items = _spawn(worker.train_loop, 2, dirs)
  (_, s0, files0), (_, s1, files1) = items[0], items[1]
  assert int(s0["train_state/step"]) == 4
  for key in s0:
    np.testing.assert_array_equal(s0[key], s1[key], err_msg=key)
  assert {"ckpt", "metrics_train.jsonl", "learner_group.json"} <= set(files0)
  assert files1 is None  # no directory, no file
  with open(tmp_path / "rank0" / "learner_group.json") as f:
    group = json.load(f)
  assert group["world_size"] == 2 and group["step"] == 4
  first, second = group["rank_digests"]
  assert first == second and len(first) == len(
      [k for k in s0 if k.startswith(("train_state/params/",
                                      "train_state/batch_stats/"))])


def test_world_size_one_is_the_single_learner_bit_for_bit(tmp_path):
  ctx = mp.get_context("spawn")
  finals = {}
  for world in (0, 1):
    out = ctx.Queue()
    p = ctx.Process(target=worker.train_loop, args=(
        distributed.ephemeral_coordinator_address(), world, 0,
        str(tmp_path / f"world{world}"), out), daemon=True)
    p.start()
    try:
      finals[world] = out.get(timeout=_TIMEOUT)[1]
    finally:
      p.join(timeout=30)
      if p.is_alive():
        p.kill()
    assert p.exitcode == 0
  assert set(finals[0]) == set(finals[1])
  for key, value in finals[0].items():
    assert value.dtype == finals[1][key].dtype, key
    np.testing.assert_array_equal(value, finals[1][key], err_msg=key)


# ---- the plan and the mesh ----


def test_learner_group_plan_matches_jax():
  config = FleetConfig(batch_size=16)
  for world, rank in ((1, 0), (2, 0), (2, 1), (4, 3)):
    assert (learner_group_plan(config, world, rank)
            == jax_learner_group_plan(config, world, rank))
  for world, rank, match in ((3, 0, "divide"), (2, 2, "rank"),
                             (0, 0, "world_size")):
    for fn in (learner_group_plan, jax_learner_group_plan):
      with pytest.raises(ValueError, match=match):
        fn(config, world, rank)


def test_the_data_axis_mesh():
  mesh = mesh_lib.create_mesh(devices=["cpu"])
  assert mesh.axis_names == ("data",) and mesh.shape == {"data": 1}
  assert mesh.size == 1 and mesh.rank == 0
  assert mesh_lib.create_mesh({"data": -1}, devices=["cpu"]).size == 1
  with pytest.raises(ValueError, match="needs 2 devices"):
    mesh_lib.create_mesh({"data": 2}, devices=["cpu"])
  for shapes, devices in (({"data": 1, "stage": 1}, ["cpu"]),
                          ({"model": 1}, ["cpu"]),
                          (None, ["cpu", "cpu"])):
    with pytest.raises(NotImplementedError, match="A11 rest"):
      mesh_lib.create_mesh(shapes, devices=devices)
  with pytest.raises(NotImplementedError, match="A11 rest"):
    mesh_lib.shard_map_compat(None, mesh, in_specs=(), out_specs=())
