"""Functional environments over batched tensors (port of `envs/core.py`).

The JAX package writes each env for one episode and `vmap`s it; the
port writes each env for a batch directly: every leaf of a state has a
leading env dimension `[N, ...]`, and every method works on the whole
batch at once. Keys become `torch.Generator`s on the state's device.

The contract:

  * an env state is a dataclass of tensors holding everything an
    episode owns (geometry, step counter, the episode's sensor noise);
  * ``reset(generator, num_envs) -> state`` samples `num_envs` fresh
    episodes. The draws a call makes depend only on `num_envs` and the
    env's static sizes, never on the data, so a CUDA graph can capture
    them;
  * ``observe(state) -> {name: tensor}`` renders the observation, a
    pure function of the state. The JAX envs keep a noise key in the
    state and redraw the same noise from it on every observe; torch has
    no splittable keys, so the port draws an episode's noise once, at
    reset, and keeps the noisy background in the state: every frame of
    an episode carries the same noise, as in JAX;
  * ``step(state, action, generator) -> (state', obs', reward, done)``:
    `obs'` is the post-transition observation (the terminal one when
    `done`), `reward` f32 `[N]`, `done` bool `[N]`.

`AutoResetEnv` replaces a finished episode inside `step`: it draws the
reset for every env at every step and picks it with `torch.where` where
`done` (the JAX `select_state` under `vmap` computes both branches the
same way), so no step branches on data. `BatchedEnv` fixes the number
of envs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

EnvState = Any
Observation = Dict[str, torch.Tensor]


class FunctionalEnv:
  """Base class pinning the batched functional contract (see module
  docstring). Subclasses hold only static hyperparameters; everything
  episode-specific lives in the state."""

  @property
  def action_dim(self) -> int:
    raise NotImplementedError

  def observation_shapes(self) -> Dict[str, tuple]:
    """{name: shape} of a single (unbatched) observation."""
    raise NotImplementedError

  def reset(self, generator: torch.Generator, num_envs: int) -> EnvState:
    raise NotImplementedError

  def observe(self, state: EnvState) -> Observation:
    raise NotImplementedError

  def step(self, state: EnvState, action: torch.Tensor,
           generator: torch.Generator
           ) -> Tuple[EnvState, Observation, torch.Tensor, torch.Tensor]:
    raise NotImplementedError


def num_envs_of(state: EnvState) -> int:
  """The leading env dimension of a state."""
  return dataclasses.astuple(state)[0].shape[0]


def select_state(done: torch.Tensor, if_done: EnvState,
                 if_not: EnvState) -> EnvState:
  """Per-leaf `where(done, a, b)` over two matching batched states;
  `done` `[N]` broadcasts from the left against every leaf."""

  def pick(a, b):
    mask = done.reshape(done.shape + (1,) * (a.dim() - 1))
    return torch.where(mask, a, b)

  return dataclasses.replace(if_not, **{
      f.name: pick(getattr(if_done, f.name), getattr(if_not, f.name))
      for f in dataclasses.fields(if_not)})


class AutoResetEnv(FunctionalEnv):
  """Replaces a finished episode with a fresh one inside ``step``.

  ``step`` returns the TERMINAL observation as ``obs'`` (so a
  transition's ``next_obs`` is real), while the returned state is
  already the next episode's reset state where ``done``. The step's
  draws come first from the generator, then the reset's, for every env
  at every step.
  """

  def __init__(self, env: FunctionalEnv):
    self.env = env

  @property
  def action_dim(self) -> int:
    return self.env.action_dim

  def observation_shapes(self) -> Dict[str, tuple]:
    return self.env.observation_shapes()

  def reset(self, generator, num_envs):
    return self.env.reset(generator, num_envs)

  def observe(self, state):
    return self.env.observe(state)

  def step(self, state, action, generator):
    stepped, obs, reward, done = self.env.step(state, action, generator)
    fresh = self.env.reset(generator, num_envs_of(state))
    return select_state(done, fresh, stepped), obs, reward, done


class BatchedEnv:
  """A fixed number of envs: ``reset(generator)`` samples ``num_envs``
  independent episodes; ``observe`` and ``step`` pass the batch through
  (the port's envs are batched already, where JAX `vmap`s here)."""

  def __init__(self, env: FunctionalEnv, num_envs: int):
    if num_envs < 1:
      raise ValueError(f"num_envs must be >= 1, got {num_envs}")
    self.env = env
    self.num_envs = int(num_envs)

  @property
  def action_dim(self) -> int:
    return self.env.action_dim

  def reset(self, generator: torch.Generator) -> EnvState:
    return self.env.reset(generator, self.num_envs)

  def observe(self, states: EnvState) -> Observation:
    return self.env.observe(states)

  def step(self, states, actions, generator):
    return self.env.step(states, actions, generator)
