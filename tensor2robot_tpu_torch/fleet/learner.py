"""Fleet learner process (port of `fleet/learner.py`): `train_qtopt`
on the host's replay plane.

The learner is the unmodified QT-Opt loop (the same graphed Bellman
step, checkpoint writer and metric log) handed two fleet-shaped seams
instead of an in-process buffer:

  * `RemoteReplay`: the `replay_buffer=` facade. Sampling rides the
    host's `ReplayBatchSampler` (so staleness is accounted where the
    data lives), `set_learner_step` tags the store every dispatch (the
    staleness and lag clock), and the train log's replay metrics come
    back over the control channel. Two RPC clients on purpose: the
    prefetch thread owns the sampling connection, the train loop owns
    control (`rpc.RpcClient` is single-owner).
  * `ParamPublishHook`: the param-publication channel. On every
    checkpoint it ships the acting half of the train state (params and
    batch stats, no optimizer state) to the host as host numpy, after
    synchronizing the card, and the host hot-swaps it into its serving
    engine stamped with the learner step. It declares
    `drives_online_collection`, so the trainer's prefetch depth drops to
    the online-correct 1.

The learner runs on `FleetConfig.device` (None = the card).
`distributed_learner=True` is the plain learner at world size 1, bit for
bit. `FleetConfig.learner_hosts = N > 1` makes it a learner group: N
processes (rank 0 is "learner", the others "learner-r<rank>") join one
gloo group at an orchestrator-issued coordinator address, each samples
`batch_size / N` rows and `train_qtopt` averages the gradients over the
group (`learner_group_plan` is the per-rank contract). Only rank 0
publishes, checkpoints and logs, and carries the crash hooks.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from tensor2robot_tpu_torch import telemetry
from tensor2robot_tpu_torch.fleet import faults as faults_lib
from tensor2robot_tpu_torch.fleet import proc
from tensor2robot_tpu_torch.fleet.actor import address_book
from tensor2robot_tpu_torch.fleet.rpc import RpcClient
from tensor2robot_tpu_torch.hooks.hook import Hook
from tensor2robot_tpu_torch.telemetry import flightrec
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

log = logging.getLogger(__name__)

# A learner rank waits this long for its peers: at the group's
# rendezvous and at every collective (gloo's timeout). A rank that died
# is caught sooner by the orchestrator's supervision, which takes the
# group down.
GROUP_TIMEOUT_SECS = 300.0


class RemoteReplay:
  """`train_qtopt`-facing replay facade over the fleet's replay plane.

  Unsharded (the single-host default): every call rides the host's
  control/stream clients. Sharded (`replay_hosts > 0`): a batch is
  assembled from per-shard `sample` RPCs, counts proportional to shard
  fill, concatenated shard-major (`replay.sampler.shard_fanout_counts`
  / `concat_shard_major`), and `set_learner_step` tags every shard's
  store so staleness and lag stay correct where each shard lives.
  Client ownership follows the module contract: `*_controls` belong to
  the train thread, `*_streams` to the prefetch thread.
  """

  def __init__(self, control: RpcClient, stream: RpcClient,
               capacity: int,
               shard_controls: Sequence[RpcClient] = (),
               shard_streams: Sequence[RpcClient] = ()):
    self._control = control
    self._stream = stream
    self._capacity = int(capacity)
    self._shard_controls = list(shard_controls)
    self._shard_streams = list(shard_streams)

  @property
  def capacity(self) -> int:
    return self._capacity

  def __len__(self) -> int:
    if self._shard_controls:
      return sum(int(c.call("size")) for c in self._shard_controls)
    return int(self._control.call("size"))

  def wait_until_size(self, min_size: int,
                      timeout_secs: Optional[float] = None) -> bool:
    deadline = (time.monotonic() + timeout_secs
                if timeout_secs is not None else None)
    while len(self) < min_size:
      if deadline is not None and time.monotonic() > deadline:
        return False
      time.sleep(0.05)
    return True

  def _to_struct(self, flat: Dict[str, Any]):
    from tensor2robot_tpu_torch.specs import TensorSpecStruct
    return TensorSpecStruct.from_flat_dict(flat)

  def _fanout_sample(self, clients: List[RpcClient], batch_size: int):
    """One shard-major batch via per-shard RPCs on `clients` (which
    must belong to the calling thread — single-owner rule)."""
    from tensor2robot_tpu_torch.replay.sampler import (
        concat_shard_major,
        shard_fanout_counts,
    )
    sizes = tuple(int(c.call("size")) for c in clients)
    counts = shard_fanout_counts(batch_size, sizes)
    parts = [client.call("sample", count)
             for client, count in zip(clients, counts) if count]
    return self._to_struct(concat_shard_major(parts))

  def sample(self, batch_size: int):
    """Control-channel sample (int8 calibration runs pre-loop, on the
    train thread, before the prefetcher owns the stream channel)."""
    if self._shard_controls:
      return self._fanout_sample(self._shard_controls, int(batch_size))
    return self._to_struct(self._control.call("sample", int(batch_size)))

  def as_stream(self, batch_size: int) -> Iterator[Any]:
    def _gen():
      while True:
        if self._shard_streams:
          yield self._fanout_sample(self._shard_streams,
                                    int(batch_size))
        else:
          yield self._to_struct(
              self._stream.call("sample", int(batch_size)))
    return _gen()

  def set_learner_step(self, step: int) -> None:
    # The root host always gets the tag (its learner-window/resume
    # witness), and on the sharded plane so does every shard: the
    # staleness/lag clock must tick where the rows live.
    self._control.call("set_learner_step", int(step))
    for client in self._shard_controls:
      client.call("set_learner_step", int(step))

  def metrics_scalars(self) -> Dict[str, float]:
    out = dict(self._control.call("metrics_scalars"))
    merged: Dict[str, float] = {}
    for client in self._shard_controls:
      for key, value in client.call("metrics_scalars").items():
        if any(tag in key for tag in ("mean", "max", "p95")):
          # Distributional scalars don't sum across shards; the
          # pessimistic envelope (max) is the honest merge.
          merged[key] = max(merged.get(key, 0.0), float(value))
        else:
          merged[key] = merged.get(key, 0.0) + float(value)
    out.update(merged)
    return out


def publication(state) -> Dict[str, Any]:
  """The acting half of a `TrainState` (params and batch stats) as host
  numpy, copied after the card's stream is synchronized: only numpy
  crosses an RPC (a pickled CUDA tensor would open a CUDA context in
  the receiver)."""
  import torch

  tensors = {**state.params, **state.batch_stats}
  for device in {t.device for t in tensors.values()}:
    if device.type == "cuda":
      torch.cuda.synchronize(device)

  def host(arrays) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in arrays.items()}

  return {"step": int(state.step), "params": host(state.params),
          "batch_stats": host(state.batch_stats)}


class ParamPublishHook(Hook):
  """Publishes each checkpoint's acting params to the fleet host."""

  drives_online_collection = True

  def __init__(self, control: RpcClient, telemetry_push: bool = True):
    self._control = control
    self._telemetry_push = telemetry_push
    self.publishes = 0

  def after_checkpoint(self, step: int, state, model_dir: str) -> None:
    with telemetry.span("learner.publish_params", step=int(step)):
      # `origin_wall`/`hop` seed the broadcast tree's per-hop
      # accounting: every host that swaps this publication, root or
      # forwarded, measures origin→swap against the shared wall clock
      # and tags its depth.
      self._control.call("publish", {
          "step": int(step),
          "state": publication(state),
          "origin_wall": time.time(),
          "hop": 0,
      })
    self.publishes += 1
    tmetrics.counter("learner.param_publishes").inc()
    # Publish cadence doubles as the learner's telemetry-push cadence
    # (the control client is owned by this thread: RpcClient is
    # single-owner). Skipped when the plane is off.
    if not self._telemetry_push:
      return
    proc.record_cuda_state()
    try:
      self._control.call("telemetry_push", {
          "role": "learner",
          "snapshot": tmetrics.registry().snapshot()})
    except Exception:  # noqa: BLE001 — instrumentation only
      log.warning("learner telemetry push failed", exc_info=True)


class _TelemetryPushHook(Hook):
  """A non-chief rank's registry snapshot at each checkpoint (the chief
  pushes with its publication): its `proc.cuda_initialized` and
  `fleet.learner_group.*` reach the aggregated view under its role."""

  def __init__(self, control: RpcClient, role: str):
    self._control = control
    self._role = role

  def after_checkpoint(self, step: int, state, model_dir: str) -> None:
    proc.record_cuda_state()
    try:
      self._control.call("telemetry_push", {
          "role": self._role,
          "snapshot": tmetrics.registry().snapshot()})
    except Exception:  # noqa: BLE001 — instrumentation only
      log.warning("%s telemetry push failed", self._role, exc_info=True)


class _HeartbeatHook(Hook):
  """Stamps the orchestrator-visible heartbeat every train step."""

  def __init__(self, heartbeat):
    self._heartbeat = heartbeat

  def after_step(self, step: int, metrics) -> None:
    proc.beat(self._heartbeat)


class _CrashAfterHook(Hook):
  """Fault injection: kill the learner mid-run."""

  def __init__(self, crash_after_steps: int):
    self._after = int(crash_after_steps)

  def after_step(self, step: int, metrics) -> None:
    if step >= self._after:
      raise RuntimeError(
          "injected learner crash "
          "(FleetConfig.learner_crash_after_steps)")


class _FaultPlanHook(Hook):
  """The learner's fault-plan seam: `on_step` after every train step.

  A due `learner_crash` raises out of the train loop — the same except
  path a real crash takes (flight record in `learner_main`, exit code
  seen by the orchestrator, `resume` policy respawns from the latest
  checkpoint)."""

  def __init__(self, injector: faults_lib.FaultInjector):
    self._injector = injector

  def after_step(self, step: int, metrics) -> None:
    event = self._injector.on_step(step)
    if event is not None:
      raise RuntimeError(
          f"injected learner crash (fault plan, step {step})")


def learner_group_plan(config, world_size: int = 1,
                       rank: int = 0) -> Dict[str, Any]:
  """The learner group's per-rank contract, as pure math.

  Every rank samples and feeds `local_batch_size` rows (`train_qtopt`
  averages the gradients over the group), but only rank 0 publishes
  params and owns the host-side surfaces. At `world_size == 1` this is
  the single-learner path: the same role name, the same batch,
  publishing on."""
  world_size = int(world_size)
  rank = int(rank)
  if world_size < 1:
    raise ValueError(f"world_size must be >= 1, got {world_size}")
  if not 0 <= rank < world_size:
    raise ValueError(
        f"rank must be in [0, {world_size}), got {rank}")
  if config.batch_size % world_size != 0:
    raise ValueError(
        f"batch_size ({config.batch_size}) must divide evenly "
        f"across the learner group (world_size={world_size})")
  return {
      "role": "learner" if rank == 0 else f"learner-r{rank}",
      "local_batch_size": config.batch_size // world_size,
      "publishes": rank == 0,
  }


def learner_main(config, model_dir: str, address, heartbeat,
                 coordinator_address: Optional[str] = None,
                 incarnation: int = 0, world_size: int = 1,
                 rank: int = 0) -> None:
  """Child-process entry: connect → train_qtopt → clean exit.

  ``incarnation`` > 0 is the `learner_crash_policy="resume"` respawn:
  `train_qtopt` restores from the latest checkpoint in `model_dir` (the
  host kept the replay store and serving engine alive), and
  non-recurring planned faults do not re-fire. `address` is the address
  book, or a pipe end that delivers it once the hosts are up
  (`proc.await_address`); the model stack loads and the learner is
  built first, while they come up.

  ``world_size`` > 1 makes this process rank ``rank`` of a learner
  group: every rank adopts the same ``coordinator_address`` and joins
  one gloo group (`parallel.distributed.maybe_initialize_distributed`),
  then runs `train_qtopt` on its `batch_size / world_size` rows. Rank 0
  is the chief: the only rank that publishes params, writes checkpoints
  and logs.
  """
  plan = learner_group_plan(config, world_size, rank)
  proc.scrub_inherited_distributed_env()
  if coordinator_address and world_size > 1:
    proc.adopt_coordinator(coordinator_address,
                           num_processes=world_size, process_id=rank)
  from tensor2robot_tpu_torch.fleet.host import _build_learner
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import (
      train_qtopt,
  )
  learner = _build_learner(config)
  if world_size > 1:
    proc.pin_single_host_device(learner.device)
  address = proc.await_address(address)
  if address is None:
    return  # the launch was aborted before the hosts were up
  telemetry.configure(
      plan["role"], trace_dir=getattr(config, "telemetry_dir", "") or None)
  injector = faults_lib.install(config, plan["role"],
                                incarnation=incarnation)
  if incarnation:
    log.warning("learner incarnation %d: resuming from the latest "
                "checkpoint in %s", incarnation, model_dir)
  rpc_kwargs = dict(
      authkey=config.authkey,
      call_timeout_secs=config.rpc_call_timeout_secs,
      max_retries=config.rpc_max_retries,
      transport=getattr(config, "transport", "loopback"),
      sndbuf=getattr(config, "tcp_sndbuf", 0),
      rcvbuf=getattr(config, "tcp_rcvbuf", 0))
  book = address_book(address)
  root = book["serving"][0]
  control = RpcClient(root, **rpc_kwargs)
  stream = RpcClient(root, **rpc_kwargs)
  # Sharded replay plane: control clients for the train thread, stream
  # clients for the prefetch thread: two per shard, the same
  # single-owner discipline as the root pair.
  shard_controls = [RpcClient(a, **rpc_kwargs) for a in book["shards"]]
  shard_streams = [RpcClient(a, **rpc_kwargs) for a in book["shards"]]
  try:
    from tensor2robot_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    if world_size > 1 and not maybe_initialize_distributed(
        timeout_secs=GROUP_TIMEOUT_SECS):
      raise RuntimeError(
          f"learner rank {rank} of {world_size} joined no process group")
    tmetrics.gauge("fleet.learner_group.size").set(world_size)
    tmetrics.gauge("fleet.learner_group.rank").set(rank)
    t_before = time.monotonic()
    hello = control.call("hello")
    t_after = time.monotonic()
    if "monotonic" in hello:
      telemetry.get_tracer().set_clock_offset(
          telemetry.clock_offset_from_handshake(
              hello["monotonic"], t_before, t_after))
    replay = RemoteReplay(control, stream, capacity=hello["capacity"],
                          shard_controls=shard_controls,
                          shard_streams=shard_streams)
    hooks: List[Hook] = [_HeartbeatHook(heartbeat)]
    if plan["publishes"]:
      # Rank 0 only: publication, and the crash hooks that model "the
      # learner" dying (any rank's death is fatal to a group either
      # way).
      hooks.insert(0, ParamPublishHook(
          control,
          telemetry_push=bool(getattr(config, "telemetry_dir", ""))))
      if config.learner_crash_after_steps:
        hooks.append(_CrashAfterHook(config.learner_crash_after_steps))
    elif getattr(config, "telemetry_dir", ""):
      hooks.append(_TelemetryPushHook(control, plan["role"]))
    if injector.active:
      hooks.append(_FaultPlanHook(injector))
    train_qtopt(
        learner=learner,
        model_dir=model_dir,
        replay_buffer=replay,
        max_train_steps=config.max_train_steps,
        # The per-process batch: the group trains on `batch_size` rows
        # a step in all, as the single learner does.
        batch_size=plan["local_batch_size"],
        min_replay_size=config.min_replay_size,
        save_checkpoints_steps=config.publish_every_steps,
        log_every_steps=config.log_every_steps,
        hooks=hooks,
        seed=config.seed)
  except BaseException as e:
    # The latched-error flight record: the learner's last spans and
    # metrics survive its death.
    if getattr(config, "flightrec_dir", ""):
      flightrec.dump(config.flightrec_dir, f"{plan['role']}: {e!r}")
    raise
  finally:
    # Stop the perf plane's sampler thread before the process exits: a
    # daemon thread mid-read of the card during interpreter teardown
    # can abort the process.
    from tensor2robot_tpu_torch.telemetry import perf as perf_lib
    perf_lib.stop_resource_sampler()
    telemetry.get_tracer().close()
    for client in shard_streams + shard_controls:
      client.close()
    stream.close()
    control.close()
