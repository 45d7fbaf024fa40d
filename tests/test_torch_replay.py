"""The port's replay plane against the JAX package's.

The same seeded numpy transitions go through both packages' store
(every shard count × sampling mode, over one add sequence that wraps the
rings, splits a batch bigger than a shard, keeps only the tail of a
batch bigger than the store, mixes priorities and tags learner steps),
the sampler (schedule digest, staleness), the cross-shard and
rendezvous helpers, and the ingestion service (one scripted scenario of
drops, blocks, a crash, a restart and a writer error). Draws and rows
are integers or copies, so every comparison is exact. The native row
gather is held to numpy indexing here too (g++ builds it).
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensor2robot_tpu import specs as jax_specs  # noqa: E402
from tensor2robot_tpu.replay import (  # noqa: E402
    ReplayBatchSampler as JaxSampler,
)
from tensor2robot_tpu.replay import (  # noqa: E402
    ReplayStore as JaxStore,
)
from tensor2robot_tpu.replay import (  # noqa: E402
    ReplayWriteService as JaxService,
)
from tensor2robot_tpu.replay import sampler as jax_sampler  # noqa: E402
from tensor2robot_tpu.replay import service as jax_service  # noqa: E402
from tensor2robot_tpu_torch import specs  # noqa: E402
from tensor2robot_tpu_torch.replay import (  # noqa: E402
    ActorIngestSession,
    ReplayBatchSampler,
    ReplayStore,
    ReplayWriteService,
    make_stream,
)
from tensor2robot_tpu_torch.replay import sampler  # noqa: E402
from tensor2robot_tpu_torch.replay import service  # noqa: E402
from tensor2robot_tpu_torch.utils import native  # noqa: E402

_SHAPES = {"image": ((4, 4, 3), np.uint8), "action": ((2,), np.float32),
           "reward": ((1,), np.float32)}


def _spec(module):
  st = module.TensorSpecStruct()
  for key, (shape, dtype) in _SHAPES.items():
    st[key] = module.ExtendedTensorSpec(shape=shape, dtype=dtype, name=key)
  return st


def _batch(n, seed):
  rng = np.random.default_rng(seed)
  return {"image": rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8),
          "action": rng.standard_normal((n, 2)).astype(np.float32),
          "reward": rng.random((n, 1)).astype(np.float32)}


# (rows, priority, learner step tagged before the add): wraps every
# ring, one batch (13) larger than a shard of 2 or 3 and one (30)
# larger than the store, priorities mixed (zero included).
_ADDS = ((5, None, 0), (7, 0.5, 1), (13, 2.0, 3), (30, 0.0, 4), (11, 1.0, 6),
         (2, 3.0, 9))
_CAPACITY = 24


def _filled(num_shards, sampling, spill_root=None):
  stores = []
  for module, store_cls, name in ((jax_specs, JaxStore, "jax"),
                                  (specs, ReplayStore, "port")):
    spill = None if spill_root is None else os.path.join(spill_root, name)
    stores.append(store_cls(_spec(module), capacity=_CAPACITY,
                            num_shards=num_shards, seed=7,
                            sampling=sampling, spill_dir=spill))
  for i, (n, priority, step) in enumerate(_ADDS):
    for store in stores:
      store.set_learner_step(step)
      assert store.add(_batch(n, seed=i), priority=priority) == min(
          n, _CAPACITY)
  return stores


def _equal_batches(got, want):
  got, want = got.to_flat_dict(), want.to_flat_dict()
  assert list(got) == list(want)
  for key in want:
    np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                  err_msg=key)


@pytest.mark.parametrize("sampling", ["uniform", "fifo", "prioritized"])
@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_store_draws_rows_ages_and_spill_as_jax(num_shards, sampling,
                                                tmp_path):
  jax_store, store = _filled(num_shards, sampling, str(tmp_path))
  assert store.shard_sizes() == jax_store.shard_sizes()
  assert len(store) == len(jax_store)
  for i, batch_size in enumerate((7, 16, 40, 3)):
    for s in (jax_store, store):
      # Step 5 is below the last adds' tags: their ages clamp at 0.
      s.set_learner_step(5 if i == 0 else 10 + i)
    want, want_ages, want_ids = jax_store.sample_with_ages(batch_size)
    got, ages, ids = store.sample_with_ages(batch_size)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(ages, want_ages)
    _equal_batches(got, want)
  assert store.metrics_snapshot() == jax_store.metrics_snapshot()
  assert set(store.metrics_scalars()) == set(jax_store.metrics_scalars())
  names = sorted(os.listdir(tmp_path / "jax"))
  assert names and names == sorted(os.listdir(tmp_path / "port"))
  for name in names:
    with np.load(tmp_path / "jax" / name) as want, \
        np.load(tmp_path / "port" / name) as got:
      assert sorted(got.files) == sorted(want.files)
      for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  assert (store.num_shards, store.shard_capacity, store.sampling,
          store.learner_step) == (jax_store.num_shards,
                                  jax_store.shard_capacity,
                                  jax_store.sampling, jax_store.learner_step)
  assert list(store.transition_spec.to_flat_dict()) == list(
      jax_store.transition_spec.to_flat_dict())


def test_prioritized_all_zero_priorities_draw_uniformly():
  stores = [JaxStore(_spec(jax_specs), capacity=12, num_shards=2, seed=3,
                     sampling="prioritized"),
            ReplayStore(_spec(specs), capacity=12, num_shards=2, seed=3,
                        sampling="prioritized")]
  for store in stores:
    store.add(_batch(9, seed=0), priority=0.0)
  (_, _, want), (_, _, got) = (s.sample_with_ages(20) for s in stores)
  np.testing.assert_array_equal(got, want)


def test_fifo_is_oldest_first_and_wraps_all_cursors_together():
  store = ReplayStore(_spec(specs), capacity=12, num_shards=3, seed=0,
                      sampling="fifo")
  for i, n in enumerate((2, 3, 1)):
    batch = _batch(n, seed=i)
    batch["reward"] = (np.arange(n, dtype=np.float32) + 10 * i)[:, None]
    store.add(batch)
  rewards = store.sample(12).to_flat_dict()["reward"][:, 0]
  order = [0, 1, 10, 11, 12, 20]
  np.testing.assert_array_equal(rewards, order + order)


def test_store_input_errors():
  store = ReplayStore(_spec(specs), capacity=8)
  with pytest.raises(ValueError, match="empty replay store"):
    store.sample(1)
  with pytest.raises(KeyError, match="reward"):
    store.add({k: v for k, v in _batch(2, 0).items() if k != "reward"})
  with pytest.raises(ValueError, match="priority"):
    store.add(_batch(2, 0), priority=-1.0)
  with pytest.raises(ValueError, match="sampling"):
    ReplayStore(_spec(specs), sampling="lifo")
  with pytest.raises(ValueError, match="num_shards"):
    ReplayStore(_spec(specs), num_shards=0)
  with pytest.raises(ValueError, match="capacity"):
    ReplayStore(_spec(specs), capacity=2, num_shards=3)
  assert store.add(_batch(0, 0)) == 0


def test_concurrent_adds_keep_every_count():
  """Actors adding on many threads: no update of the counters or the
  ring bookkeeping is lost."""
  store = ReplayStore(_spec(specs), capacity=4096, num_shards=3)
  import sys
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    threads = [threading.Thread(
        target=lambda s=seed: [store.add(_batch(3, s)) for _ in range(40)])
        for seed in range(12)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=60)
  finally:
    sys.setswitchinterval(interval)
  assert not any(t.is_alive() for t in threads)
  assert store.adds_total == len(store) == 12 * 40 * 3
  assert store.add_calls == 12 * 40
  assert sum(store.shard_sizes()) == 1440


# ---- the sampler ----


@pytest.mark.parametrize("sampling", ["uniform", "fifo", "prioritized"])
@pytest.mark.parametrize("num_shards", [1, 3])
def test_sampler_digest_and_staleness_equal_jax(num_shards, sampling):
  jax_store, store = _filled(num_shards, sampling)
  jax_s = JaxSampler(jax_store, 9, record_schedule=True)
  _, port_s = make_stream(store, 9, record_schedule=True)
  for i in range(5):
    for s in (jax_store, store):
      s.set_learner_step(12 + 3 * i)
    _equal_batches(port_s.sample(), jax_s.sample())
  assert port_s.schedule_digest() == jax_s.schedule_digest()
  assert port_s.staleness_snapshot() == jax_s.staleness_snapshot()
  assert port_s.metrics_scalars() == jax_s.metrics_scalars()
  assert port_s.wire_spec is store.transition_spec
  assert (port_s.batch_size, port_s.store) == (9, store)
  stream = port_s.as_stream()
  assert next(stream).to_flat_dict()["image"].shape == (9, 4, 4, 3)


def test_schedule_digest_needs_recording():
  _, store = _filled(1, "uniform")
  with pytest.raises(RuntimeError, match="record_schedule"):
    ReplayBatchSampler(store, 4).schedule_digest()


@pytest.mark.parametrize("batch_size", [0, 1, 7, 64, 255])
@pytest.mark.parametrize("sizes", [(10,), (5, 5), (1, 0, 9), (3, 7, 11, 2),
                                   (0, 4), (100, 1, 1)])
def test_shard_fanout_counts_equal_jax(batch_size, sizes):
  got = sampler.shard_fanout_counts(batch_size, sizes)
  assert got == jax_sampler.shard_fanout_counts(batch_size, sizes)
  assert sum(got) == batch_size


def test_fanout_and_concat_errors_equal_jax():
  for module in (sampler, jax_sampler):
    with pytest.raises(ValueError, match="every shard"):
      module.shard_fanout_counts(4, (0, 0))
    with pytest.raises(ValueError, match="batch_size"):
      module.shard_fanout_counts(-1, (3,))
    with pytest.raises(ValueError, match="no shard"):
      module.concat_shard_major([])


@pytest.mark.parametrize("parts", [1, 3])
def test_concat_shard_major_equals_jax(parts):
  flat = [{k: v for k, v in _batch(2 + i, seed=i).items()}
          for i in range(parts)]
  got = sampler.concat_shard_major(flat)
  want = jax_sampler.concat_shard_major(flat)
  assert list(got) == list(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("key", ["actor-0", "actor-17", "tenant/α", ""])
@pytest.mark.parametrize("buckets", [range(1), range(4), [5, 2, 9, 2],
                                     range(16)])
def test_rendezvous_equals_jax(key, buckets):
  buckets = list(buckets)
  for b in buckets:
    assert (sampler.rendezvous_weight(key, b)
            == jax_sampler.rendezvous_weight(key, b))
  assert (sampler.rendezvous_rank(key, buckets)
          == jax_sampler.rendezvous_rank(key, buckets))
  assert (sampler.rendezvous_choose(key, buckets)
          == jax_sampler.rendezvous_choose(key, buckets))
  for k in (1, 2, 5):
    assert (sampler.rendezvous_spread(key, buckets, k)
            == jax_sampler.rendezvous_spread(key, buckets, k))


def test_rendezvous_errors():
  with pytest.raises(ValueError, match="at least one"):
    sampler.rendezvous_rank("a", [])
  with pytest.raises(ValueError, match="k must be"):
    sampler.rendezvous_spread("a", [1], 0)


# ---- the ingestion service ----


def _wait(cond, secs=10.0):
  deadline = time.monotonic() + secs
  while not cond():
    assert time.monotonic() < deadline, "timed out"
    time.sleep(0.002)


def _scenario(spec_module, store_cls, service_cls):
  """One scripted run; returns (counters per service, store, sessions'
  commit counts, errors seen). The writer is held on the store's sampler
  lock to make the queue's fill, and so each drop, deterministic."""
  store = store_cls(_spec(spec_module), capacity=40, num_shards=2, seed=1)
  out = {}
  # Drop overflow: one batch in the writer's hands, two queued, the
  # fourth dropped.
  drop = service_cls(store, queue_batches=2, overflow="drop")
  a = drop.session("actor-a")
  with store._sample_lock:
    assert a.add(_batch(3, 0))
    _wait(lambda: drop.queue_depth == 0)
    assert a.add(_batch(3, 1)) and a.add(_batch(3, 2))
    assert not a.add(_batch(3, 3))
  assert drop.flush()
  # A crash mid-episode, then a restart under the same id.
  a.begin_episode()
  a.append(_batch(2, 4))
  a.begin_episode()            # a begin without an end: the partial goes
  a.append(_batch(2, 5))
  a.append(_batch(1, 6))
  restarted = drop.session("actor-a")
  with pytest.raises(RuntimeError, match="closed"):
    a.append(_batch(1, 7))
  restarted.begin_episode()
  restarted.append(_batch(2, 8))
  restarted.append(_batch(2, 9))
  assert restarted.end_episode(priority=2.0)
  assert not restarted.end_episode()
  assert drop.put(_batch(4, 10))
  drop.close()
  out["drop"] = drop.metrics_scalars()
  # Block overflow: a capped wait drops; an uncapped one waits its turn.
  block = service_cls(store, queue_batches=1, overflow="block",
                      block_timeout_secs=0.05)
  b = block.session("actor-b")
  with store._sample_lock:
    assert b.add(_batch(2, 11))
    _wait(lambda: block.queue_depth == 0)
    assert b.add(_batch(2, 12))
    assert not b.add(_batch(2, 13))   # the capped wait expires
  block.close()
  out["block"] = block.metrics_scalars()
  waits = service_cls(store, queue_batches=1, overflow="block")
  accepted = []
  with store._sample_lock:
    waits.put(_batch(1, 14))
    _wait(lambda: waits.queue_depth == 0)
    waits.put(_batch(1, 15))
    t = threading.Thread(target=lambda: accepted.append(
        waits.put(_batch(1, 16))))
    t.start()
    time.sleep(0.1)
    assert t.is_alive()            # backpressure: the producer waits
  t.join(timeout=10)
  assert accepted == [True]
  waits.close()
  out["wait"] = waits.metrics_scalars()
  # A writer error is latched and raised again.
  broken = service_cls(store, queue_batches=4, overflow="drop")
  broken.put({"image": _batch(1, 17)["image"]})   # no action, no reward
  errors = []
  for call in (broken.flush, lambda: broken.put(_batch(1, 18)),
               broken.close):
    with pytest.raises(RuntimeError, match="writer thread died") as e:
      _wait(lambda: broken._error is not None)
      call()
    errors.append(type(e.value.__cause__).__name__)
  out["broken"] = broken.metrics_scalars()
  commits = (a.episodes_committed, a.transitions_committed,
             restarted.episodes_committed, restarted.transitions_committed,
             b.episodes_committed)
  return out, store, commits, errors


def test_service_scenario_equals_jax():
  want, jax_store, want_commits, want_errors = _scenario(
      jax_specs, JaxStore, JaxService)
  got, store, commits, errors = _scenario(specs, ReplayStore,
                                          ReplayWriteService)
  assert got == want
  assert commits == want_commits
  assert errors == want_errors == ["KeyError"] * 3
  assert got["drop"]["replay_dropped_batches"] == 1.0
  assert got["drop"]["replay_aborted_episodes"] == 2.0
  assert got["drop"]["replay_actor_restarts"] == 1.0
  assert got["block"]["replay_dropped_transitions"] == 2.0
  assert store.metrics_snapshot() == jax_store.metrics_snapshot()
  for s, js in zip(store._shards, jax_store._shards):
    assert (s.size, s.insert) == (js.size, js.insert)
    for key in _SHAPES:
      np.testing.assert_array_equal(s.storage[key], js.storage[key])
    np.testing.assert_array_equal(s.priority, js.priority)
    np.testing.assert_array_equal(s.add_seq, js.add_seq)


def test_service_rejects_an_unknown_policy():
  store = ReplayStore(_spec(specs), capacity=4)
  with pytest.raises(ValueError, match="overflow"):
    ReplayWriteService(store, overflow="spill")
  assert isinstance(ReplayWriteService(store).session("x"),
                    ActorIngestSession)


@pytest.mark.parametrize("hop", [None, 0, 2])
def test_lag_stats_and_front_equal_jax(hop):
  stats = []
  for module, store_cls, service_mod in (
      (jax_specs, JaxStore, jax_service), (specs, ReplayStore, service)):
    store = store_cls(_spec(module), capacity=32, seed=2)
    front = service_mod.ReplayFront(
        store, service_mod.ReplayWriteService(store, queue_batches=8))
    ctx = {}
    store.set_learner_step(20)
    for i, (lag_step, rows) in enumerate(((19, 3), (4, 2), (20, 1))):
      front.commit({"actor_id": f"a{i % 2}", "transitions": _batch(rows, i),
                    "policy_learner_step": lag_step, "policy_hop": hop}, ctx)
    front.begin_episode("a2", ctx)
    front.append({"actor_id": "a2", "transitions": _batch(2, 5)}, ctx)
    front.end_episode({"actor_id": "a2", "policy_learner_step": 0,
                       "policy_hop": hop}, ctx)
    front.begin_episode("a3", ctx)
    front.append({"actor_id": "a3", "transitions": _batch(2, 6)}, ctx)
    front.abort_sessions(ctx)
    front.service.flush()
    sample = front.sample(4)
    metrics = front.metrics()
    metrics.pop("commit_window")
    stats.append((front.lag.snapshot(), metrics, front.size(),
                  sorted(sample), front.metrics_scalars().keys()))
    front.close()
  want, got = stats
  assert got[0] == want[0]
  for key in ("store", "service", "staleness", "param_refresh_lag"):
    assert got[1][key] == want[1][key], key
  assert got[2:4] == want[2:4]
  assert set(got[4]) == set(want[4])
  assert service.LAG_BUCKETS == jax_service.LAG_BUCKETS


# ---- the native row gather ----


@pytest.mark.parametrize("num_threads", [1, 0])
@pytest.mark.parametrize("dtype,row", [(np.uint8, (64, 64, 3)),
                                       (np.float32, (4,)),
                                       (np.float32, (1,)),
                                       (np.int64, ())])
def test_native_gather_and_scatter_equal_numpy(dtype, row, num_threads):
  rng = np.random.default_rng(0)
  src = (rng.integers(0, 255, (300,) + row) if dtype != np.float32
         else rng.standard_normal((300,) + row)).astype(dtype)
  idx = rng.integers(-300, 300, 256)
  np.testing.assert_array_equal(
      native.gather_rows(src, idx, num_threads=num_threads), src[idx])
  out = np.empty((256,) + row, dtype)
  assert native.gather_rows(src, idx, out=out,
                            num_threads=num_threads) is out
  np.testing.assert_array_equal(out, src[idx])
  dst, want = src.copy(), src.copy()
  slots = rng.permutation(300)[:100] - 150   # distinct, some negative
  rows = out[:100]
  native.scatter_rows(dst, slots, rows, num_threads=num_threads)
  want[slots] = rows
  np.testing.assert_array_equal(dst, want)
  assert native.load_error() is None and native.native_available()


def test_native_gather_checks_like_numpy():
  src = np.arange(40, dtype=np.float32).reshape(10, 4)
  for bad in ([10], [-11], [0, 12]):
    with pytest.raises(IndexError, match="out of bounds"):
      native.gather_rows(src, np.array(bad))
    with pytest.raises(IndexError, match="out of bounds"):
      native.scatter_rows(src.copy(), np.array(bad),
                          np.zeros((len(bad), 4), np.float32))
  with pytest.raises(ValueError, match="out shape"):
    native.gather_rows(src, np.array([1, 2]), out=np.empty((3, 4), np.float32))
  with pytest.raises(ValueError, match="out shape"):
    native.gather_rows(src, np.array([1]), out=np.empty((1, 4), np.float64))
  with pytest.raises(ValueError, match="src shape"):
    native.scatter_rows(src.copy(), np.array([1]), np.zeros((2, 4)))
  # Layouts the library does not take go through numpy.
  strided = src[:, ::2]
  np.testing.assert_array_equal(native.gather_rows(strided, [3, 1]),
                                strided[[3, 1]])
  assert native.gather_rows(src, np.array([], np.int64)).shape == (0, 4)


def test_a_failed_build_raises_with_the_compiler_message(monkeypatch,
                                                         tmp_path):
  bad = tmp_path / "gather.cc"
  bad.write_text("this is not C++\n")
  monkeypatch.setattr(native, "SOURCE", bad)
  monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(native, "_LIB", None)
  monkeypatch.setattr(native, "_ERROR", None)
  src = np.zeros((4, 2), np.float32)
  for _ in range(2):   # and again on a later call
    with pytest.raises(native.NativeBuildError, match="gather.cc"):
      native.gather_rows(src, [1])
  assert "error" in native.load_error()
  assert not native.native_available()
  assert not list((tmp_path / "build").glob("*.tmp"))
