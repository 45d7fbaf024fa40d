"""Online actor (port of `research/qtopt/actor.py`): on-policy grasp
collection feeding the QT-Opt learner.

Actor threads share the process with the learner loop; the learner's
step is device work (one CUDA-graph replay per dispatch), so host
threads are free to run envs. Two wiring choices per actor:

  * REPLAY SINK — a `ReplayBuffer` or `ReplayStore` (direct `add`), or a
    `replay.ReplayWriteService`: each collected batch then commits as one
    atomic episode through the service's bounded queue, so a crash
    mid-episode leaves no partial rows and the queue's drop or block
    policy governs an over-eager actor.
  * ACTION SOURCE — the learner's own CEM policy (`build_policy`, run
    from the actor's thread on the state it was handed, its noise from a
    generator on the learner's device seeded `seed + 1`), or a
    `serving.CEMPolicyServer` (`policy_server=`): actions then come
    through the bucketed engine and the micro-batcher, chunked to the
    engine's `max_batch`, and each batch records the params version it
    acted with.

Exploration is ε-greedy over the CEM policy. Before the first state
handoff a local-policy actor acts uniformly at random: that is the
bootstrap phase. The collection thread catches everything, aborts the
in-flight session episode and parks (`crashed`, `crash_error`); a later
`start()` re-opens the session (the service counts the restart) and
resumes.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.hooks.hook import Hook
from tensor2robot_tpu_torch.research.qtopt.grasping_env import ToyGraspEnv
from tensor2robot_tpu_torch.utils.step_graph import copy_tree, tensors

log = logging.getLogger(__name__)


@gin.configurable
class GraspActor:
  """Collects ToyGraspEnv episodes with the current CEM policy.

  Usable synchronously (`collect_once`) or as a background thread
  (`start`/`stop`). `update_state` swaps the acting parameters
  atomically; collection before the first swap is uniform-random.
  """

  def __init__(self,
               learner,
               replay_buffer,
               env: Optional[ToyGraspEnv] = None,
               batch_episodes: int = 64,
               epsilon: float = 0.1,
               cem_population: Optional[int] = None,
               cem_iterations: Optional[int] = None,
               seed: int = 0,
               policy_server=None,
               name: Optional[str] = None):
    self._replay = replay_buffer
    self.name = name or f"actor-{seed}"
    # A ReplayWriteService hands out per-actor sessions; anything with
    # .add (ReplayBuffer, ReplayStore, a session) is written directly.
    self._service = (replay_buffer
                     if hasattr(replay_buffer, "session") else None)
    self._session = (self._service.session(self.name)
                     if self._service is not None else None)
    if env is None and learner is None:
      raise ValueError(
          "GraspActor needs either an env or a learner (the default "
          "env is sized from the learner's model).")
    self._env = env or ToyGraspEnv(
        image_size=learner.model.image_size,
        action_dim=learner.model.action_dim, seed=seed)
    self._batch = batch_episodes
    self._epsilon = float(epsilon)
    self.policy_server = policy_server
    if policy_server is None:
      self._policy = learner.build_policy(cem_population=cem_population,
                                          cem_iterations=cem_iterations)
      self._generator = torch.Generator(
          device=learner.device).manual_seed(seed + 1)
    else:
      self._policy = None
      self._generator = None
    self._rng = np.random.default_rng(seed)
    self._state = None
    self._state_lock = threading.Lock()
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self.episodes_collected = 0
    self.episodes_dropped = 0
    self.reward_sum = 0.0
    self.crashed = False
    self.crash_error: Optional[BaseException] = None
    # The params version each collected batch acted with, where the
    # action source has one (a CEMPolicyServer).
    self.last_policy_version: Optional[int] = None
    self.episodes_by_policy_version: Dict[int, int] = {}

  def update_state(self, state) -> None:
    """Swaps the acting parameters (called from the trainer thread).

    With a policy server the state goes to ITS hot-swap (params and
    batch statistics; the server keeps its own copy); otherwise the
    local policy's state reference swaps under the lock, and the actor
    reads it from then on (the caller hands a copy nothing else
    writes).
    """
    if self.policy_server is not None:
      self.policy_server.update_state(state)
      with self._state_lock:
        self._state = state  # marks bootstrap as over
      return
    with self._state_lock:
      self._state = state

  def _greedy_actions(self, observations, n: int) -> np.ndarray:
    """CEM actions for the batch via the configured action source."""
    if self.policy_server is not None:
      chunk = self.policy_server.engine.max_batch
      outs = []
      for lo in range(0, n, chunk):
        outs.append(self.policy_server.select_actions(
            {"image": observations["image"][lo:lo + chunk]}))
      version = getattr(self.policy_server, "params_version", None)
      if version is not None:
        self.last_policy_version = version
        self.episodes_by_policy_version[version] = (
            self.episodes_by_policy_version.get(version, 0) + n)
      return np.concatenate(outs, axis=0).astype(np.float32)
    with self._state_lock:
      state = self._state
    actions = self._policy(state, {"image": observations["image"]},
                           generator=self._generator)
    return actions.float().cpu().numpy()

  def collect_once(self) -> float:
    """One batch of episodes → replay; returns the batch mean reward."""
    observations, positions = self._env.reset_batch(self._batch)
    n = self._batch
    random_actions = self._rng.uniform(
        -1, 1, (n, self._env.action_dim)).astype(np.float32)
    with self._state_lock:
      bootstrapped = self._state is not None
    if not bootstrapped and self.policy_server is None:
      actions = random_actions
    else:
      actions = self._greedy_actions(observations, n)
      explore = self._rng.random(n) < self._epsilon
      actions = np.where(explore[:, None], random_actions,
                         actions).astype(np.float32)
    reward = self._env.grade(actions, positions)
    transitions = {
        "image": observations["image"],
        "action": actions,
        "reward": reward[:, None].astype(np.float32),
        "done": np.ones((n, 1), np.float32),
        "next_image": observations["image"],
    }
    if self._session is not None:
      # One collected batch = one atomic episode commit; a dropped
      # commit never reached replay and is not counted as collected.
      committed = self._session.add(transitions)
    else:
      # A bare session as the sink also returns the drop policy's bool;
      # buffers and stores return None or a count.
      committed = self._replay.add(transitions) is not False
    if committed:
      self.episodes_collected += n
      self.reward_sum += float(reward.sum())
    else:
      self.episodes_dropped += n
    return float(reward.mean())

  # ---- background-thread lifecycle ----

  def start(self) -> None:
    """Starts background collection (idempotent). After a crash it
    RESTARTS: the session is re-opened (stale staged rows discarded,
    restart counted) and collection resumes."""
    if self.crashed:
      # The crashing thread sets `crashed` inside its except block, so
      # it may still be exiting: join it before restarting.
      if self._thread is not None:
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
          log.warning("actor %s crash handler still running after 30s "
                      "join; restart deferred.", self.name)
          return
        self._thread = None
      log.warning("actor %s restarting after crash: %r", self.name,
                  self.crash_error)
      self.crashed = False
      self.crash_error = None
      if self._service is not None:
        self._session = self._service.session(self.name)
    elif self._thread is not None:
      return  # alive, or cleanly stopped (stop() owns that lifecycle)
    self._stop.clear()
    self._thread = threading.Thread(target=self._run, name=self.name,
                                    daemon=True)
    self._thread.start()

  def _run(self) -> None:
    try:
      while not self._stop.is_set():
        self.collect_once()
    except BaseException as e:  # noqa: BLE001 — the crash path IS the point
      self.crash_error = e
      self.crashed = True
      if self._session is not None:
        self._session.abort()
      log.exception("actor %s crashed; partial episode discarded",
                    self.name)

  def stop(self) -> None:
    """Stops collection. A thread still running after the join timeout
    keeps its handle (a later start() cannot spawn a second collector)
    and exits at its next loop check; teardown does not raise."""
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=30.0)
      if self._thread.is_alive():
        log.warning("actor thread still running after 30s join; it will "
                    "exit at its next loop check.")
        return
      self._thread = None


def acting_copy(state):
  """The acting half of a train state (its `opt_state` dropped), as a
  fresh copy of every tensor: nothing a later step or graph replay
  writes. A CUDA copy is complete when this returns (its stream is
  synchronized), so an actor may read it on any thread and stream."""
  if dataclasses.is_dataclass(state) and hasattr(state, "opt_state"):
    state = dataclasses.replace(state, opt_state=None)
  copy = copy_tree(state)
  devices = {t.device for t in tensors(copy)}
  for device in devices:
    if device.type == "cuda":
      torch.cuda.current_stream(device).synchronize()
  return copy


@gin.configurable
class ActorStateRefreshHook(Hook):
  """Hands each checkpoint's acting params to the actors (server-wired
  actors forward the swap to their CEMPolicyServer)."""

  drives_online_collection = True

  def __init__(self, actors):
    self._actors = (list(actors) if isinstance(actors, (list, tuple))
                    else [actors])

  def begin(self, model, model_dir: str) -> None:
    for actor in self._actors:
      actor.start()

  def after_checkpoint(self, step: int, state, model_dir: str) -> None:
    acting = acting_copy(state)
    for actor in self._actors:
      actor.update_state(acting)

  def end(self, step: int, state, model_dir: str) -> None:
    for actor in self._actors:
      actor.stop()
