"""Optimizer factory and learning-rate schedules (port of
`models/optimizers.py`).

The JAX package builds optax chains; the port keeps optax's arithmetic
and its explicit state rather than `torch.optim`'s, so that a step is
held against the JAX package's bit for bit in form: a transformation is
a pair of pure functions, `init(params) -> state` and `update(grads,
state, params) -> (updates, new_state)`, over flat dicts of tensors, and
the caller adds the updates to the params (`apply_updates`). Nothing is
updated in place.

Every transformation runs on `torch._foreach_*`: one multi-tensor
launch per elementwise op over all the leaves, not one per leaf, with
the same single roundings as the per-leaf expressions (each product,
sum and quotient is its own op, never fused), so a step's arithmetic is
unchanged. `global_norm` squares the leaves in one multi-tensor launch
and sums them leaf by leaf, in the per-leaf order.

Ported: the schedules (constant, exponential, cosine and linear decay,
each with a linear warmup), and `create_optimizer` for every optimizer
the JAX one builds (adam, adamw, sgd, momentum, rmsprop, adagrad,
lamb) with the same chain order (clip by global norm → clip by value →
decayed weights → optimizer). Adam is optax's `scale_by_adam`:
bias-corrected moments, eps outside the square root, eps_root 0.
rmsprop is optax's default variant (eps inside the square root, no
centering, accumulators from 0, then momentum), adagrad its
`scale_by_rss` (accumulators from 0.1), and lamb Adam's moments with
the per-leaf trust ratio ‖p‖ / ‖u‖. These three are not torch.optim's:
its rmsprop adds eps outside the square root and its adagrad starts
from 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

import torch

from tensor2robot_tpu_torch import config as gin

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], Union[torch.Tensor, float]]
ScheduleOrFloat = Union[float, Schedule]


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
  """optax's `GradientTransformation`: `init` and `update`, both pure."""

  init: Callable[[Params], Any]
  update: Callable[[Params, Any, Optional[Params]], Tuple[Params, Any]]
  # Whether an update reads a norm over whole leaves or over every leaf
  # (clipping by the global norm, lamb's trust ratio): such an update
  # differs on a pipeline stage rank, which holds one slice of the
  # stage-stacked leaves.
  reads_norms: bool = False


class EmptyState(NamedTuple):
  pass


class ScaleByAdamState(NamedTuple):
  count: torch.Tensor  # int32 scalar: updates applied so far
  mu: Params
  nu: Params


class ScaleByScheduleState(NamedTuple):
  count: torch.Tensor  # int32 scalar


class TraceState(NamedTuple):
  trace: Params


class ScaleByRmsState(NamedTuple):
  nu: Params


class ScaleByRssState(NamedTuple):
  sum_of_squares: Params


def _count(params: Params) -> torch.Tensor:
  device = next(iter(params.values())).device if params else None
  return torch.zeros((), dtype=torch.int32, device=device)


def _zeros(params: Params) -> Params:
  return {k: torch.zeros_like(v) for k, v in params.items()}


def _tree_map(fn: Callable[..., List[torch.Tensor]], tree: Params,
              *rest: Params) -> Params:
  """`fn` over the leaf lists of `tree` (and `rest`, in `tree`'s key
  order): {key: fn(...)[i]}. An empty tree maps to an empty dict."""
  keys = list(tree)
  if not keys:
    return {}
  out = fn([tree[k] for k in keys], *([r[k] for k in keys] for r in rest))
  return dict(zip(keys, out))


def _axpby(a: float, x: List[torch.Tensor], b: float,
           y: List[torch.Tensor]) -> List[torch.Tensor]:
  """a·x + b·y leafwise, each product and the sum rounded on their own."""
  return torch._foreach_add(torch._foreach_mul(x, a),
                            torch._foreach_mul(y, b))


def global_norm(tree: Params) -> torch.Tensor:
  """optax's `global_norm`: sqrt of the sum of every leaf's squares.

  The squares are one multi-tensor product; each leaf's sum and the sum
  of those sums keep the per-leaf order (a multi-tensor norm or a sum
  over one stacked tensor would sum in another order and move the last
  bits of the norm, and of every clipped gradient)."""
  leaves = list(tree.values())
  if not leaves:
    return torch.zeros(())
  return torch.sqrt(sum(torch.sum(s) for s in torch._foreach_mul(leaves,
                                                                 leaves)))


def apply_updates(params: Params, updates: Params) -> Params:
  """optax's `apply_updates`: p + u, in p's dtype."""
  out = _tree_map(torch._foreach_add, params, updates)
  return {k: v if v.dtype == params[k].dtype else v.to(params[k].dtype)
          for k, v in out.items()}


def chain(*transforms: GradientTransformation) -> GradientTransformation:
  def init(params):
    return tuple(t.init(params) for t in transforms)

  def update(updates, state, params=None):
    new_state = []
    for t, s in zip(transforms, state):
      updates, s = t.update(updates, s, params)
      new_state.append(s)
    return updates, tuple(new_state)

  return GradientTransformation(init, update,
                                any(t.reads_norms for t in transforms))


def _stateless(fn: Callable[[Params, Optional[Params]], Params],
               reads_norms: bool = False) -> GradientTransformation:
  return GradientTransformation(
      lambda params: EmptyState(),
      lambda updates, state, params=None: (fn(updates, params), state),
      reads_norms)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
  """mu = (1−b1)·g + b1·mu; nu = (1−b2)·g² + b2·nu; count + 1;
  update = mu/(1−b1^count) / (sqrt(nu/(1−b2^count) + eps_root) + eps)."""

  def init(params):
    return ScaleByAdamState(_count(params), _zeros(params), _zeros(params))

  def update(updates, state, params=None):
    count = state.count + 1
    # As optax: the powers in f32, the division in the moment's dtype.
    c1 = 1 - torch.pow(b1, count).float()
    c2 = 1 - torch.pow(b2, count).float()

    def moments_and_update(g, mu, nu):
      mu = _axpby(1 - b1, g, b1, mu)
      nu = _axpby(1 - b2, torch._foreach_mul(g, g), b2, nu)
      den = torch._foreach_sqrt(
          torch._foreach_add(torch._foreach_div(nu, c2), eps_root))
      out = torch._foreach_div(torch._foreach_div(mu, c1),
                               torch._foreach_add(den, eps))
      return list(zip(out, mu, nu))

    both = _tree_map(moments_and_update, updates, state.mu, state.nu)
    return ({k: v[0] for k, v in both.items()},
            ScaleByAdamState(count, {k: v[1] for k, v in both.items()},
                             {k: v[2] for k, v in both.items()}))

  return GradientTransformation(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8
                 ) -> GradientTransformation:
  """optax's default `scale_by_rms`: nu = (1−decay)·g² + decay·nu from
  0; update = rsqrt(nu + eps)·g."""

  def init(params):
    return ScaleByRmsState(_zeros(params))

  def update(updates, state, params=None):
    def both(g, nu):
      nu = _axpby(1 - decay, torch._foreach_mul(g, g), decay, nu)
      scaling = torch._foreach_rsqrt(torch._foreach_add(nu, eps))
      return list(zip(torch._foreach_mul(scaling, g), nu))

    out = _tree_map(both, updates, state.nu)
    return ({k: v[0] for k, v in out.items()},
            ScaleByRmsState({k: v[1] for k, v in out.items()}))

  return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
  """optax's `scale_by_rss` (adagrad): s = g² + s from
  `initial_accumulator_value`; update = rsqrt(s + eps)·g where s > 0,
  else 0."""

  def init(params):
    return ScaleByRssState({k: torch.full_like(v, initial_accumulator_value)
                            for k, v in params.items()})

  def update(updates, state, params=None):
    def both(g, acc):
      acc = torch._foreach_add(torch._foreach_mul(g, g), acc)
      inv = [torch.where(a > 0, r, torch.zeros_like(r)) for a, r in zip(
          acc, torch._foreach_rsqrt(torch._foreach_add(acc, eps)))]
      return list(zip(torch._foreach_mul(inv, g), acc))

    out = _tree_map(both, updates, state.sum_of_squares)
    return ({k: v[0] for k, v in out.items()},
            ScaleByRssState({k: v[1] for k, v in out.items()}))

  return GradientTransformation(init, update)


def scale_by_trust_ratio() -> GradientTransformation:
  """optax's `scale_by_trust_ratio()` (lamb): each leaf's update times
  ‖p‖ / ‖u‖ (Frobenius norms), or times 1 where either norm is 0."""

  def fn(updates, params):
    if params is None:
      raise ValueError("scale_by_trust_ratio needs the params")
    out = {}
    for k, u in updates.items():
      p_norm = torch.sqrt(torch.sum(params[k] * params[k]))
      u_norm = torch.sqrt(torch.sum(u * u))
      ratio = torch.where((p_norm == 0) | (u_norm == 0),
                          torch.ones_like(p_norm), p_norm / u_norm)
      out[k] = u * ratio
    return out

  return _stateless(fn, reads_norms=True)


def scale(step_size: float) -> GradientTransformation:
  return _stateless(
      lambda u, p: _tree_map(lambda g: torch._foreach_mul(g, step_size), u))


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
  """Multiplies by `step_size_fn(count)`, count starting at 0."""

  def init(params):
    return ScaleByScheduleState(_count(params))

  def update(updates, state, params=None):
    step = step_size_fn(state.count)
    return (_tree_map(lambda g: torch._foreach_mul(g, step), updates),
            ScaleByScheduleState(state.count + 1))

  return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate: ScheduleOrFloat
                           ) -> GradientTransformation:
  if callable(learning_rate):
    return scale_by_schedule(lambda count: -learning_rate(count))
  return scale(-learning_rate)


def trace(decay: float) -> GradientTransformation:
  """Momentum: trace = g + decay·trace; the update is the new trace."""

  def init(params):
    return TraceState(_zeros(params))

  def update(updates, state, params=None):
    new = _tree_map(lambda g, t: torch._foreach_add(
        g, torch._foreach_mul(t, decay)), updates, state.trace)
    return new, TraceState(new)

  return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
  return _stateless(lambda u, p: _tree_map(
      lambda g, w: torch._foreach_add(g, torch._foreach_mul(w, weight_decay)),
      u, p))


def clip(max_delta: float) -> GradientTransformation:
  return _stateless(lambda u, p: _tree_map(
      lambda g: torch._foreach_clamp_max(
          torch._foreach_clamp_min(g, -max_delta), max_delta), u))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
  """Unchanged below `max_norm`, else (g / norm) · max_norm.

  The choice is made on the card, not the host: below the limit each
  leaf is divided and multiplied by 1 (exact), above it by the norm and
  `max_norm`."""

  def fn(updates, params):
    if not updates:
      return {}
    norm = global_norm(updates)
    trigger = norm < max_norm
    one = torch.ones_like(norm)
    div = torch.where(trigger, one, norm)
    mul = torch.where(trigger, one, torch.full_like(norm, max_norm))
    # g / norm in g's dtype, then · max_norm as a Python scalar would be.
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for k, g in updates.items():
      by_dtype.setdefault(g.dtype, []).append(k)
    out = {}
    for dtype, keys in by_dtype.items():
      leaves = [updates[k] for k in keys]
      scaled = torch._foreach_mul(
          torch._foreach_div(leaves, div.to(dtype)), mul)
      out.update(zip(keys, scaled))
    return {k: out[k] for k in updates}

  return _stateless(fn, reads_norms=True)


# ---- learning-rate schedules (optax's, as functions of a count) ----


def _f32(count) -> torch.Tensor:
  return torch.as_tensor(count).to(torch.float32)


def constant_schedule(value: float) -> Schedule:
  return lambda count: value


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, staircase: bool = False,
                      end_value: Optional[float] = None) -> Schedule:
  def schedule(count):
    p = _f32(count) / transition_steps
    if staircase:
      p = torch.floor(p)
    decayed = init_value * torch.pow(decay_rate, p)
    if end_value is not None:
      decayed = (decayed.clamp(min=end_value) if decay_rate < 1
                 else decayed.clamp(max=end_value))
    return decayed

  return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
  def schedule(count):
    count = torch.clamp(_f32(count), max=decay_steps)
    cosine = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
    return init_value * ((1 - alpha) * cosine + alpha)

  return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
  def schedule(count):
    count = torch.clamp(_f32(count), 0, transition_steps)
    frac = 1 - count / transition_steps
    return (init_value - end_value) * frac + end_value

  return schedule


def join_schedules(schedules, boundaries) -> Schedule:
  """schedules[i+1] from boundaries[i] on, counted from the boundary."""

  def schedule(count):
    count = torch.as_tensor(count)
    out = torch.as_tensor(schedules[0](count), dtype=torch.float32)
    for boundary, fn in zip(boundaries, schedules[1:]):
      out = torch.where(count < boundary, out,
                        torch.as_tensor(fn(count - boundary),
                                        dtype=torch.float32))
    return out

  return schedule


@gin.configurable
def create_lr_schedule(learning_rate: float = 1e-4,
                       schedule: str = "constant",
                       warmup_steps: int = 0,
                       decay_steps: int = 100_000,
                       decay_rate: float = 0.96,
                       end_learning_rate: float = 0.0,
                       staircase: bool = False) -> Schedule:
  """constant, exponential_decay, cosine_decay or linear_decay, each
  with an optional linear warmup from 0."""
  if schedule == "constant":
    base = constant_schedule(learning_rate)
  elif schedule == "exponential_decay":
    base = exponential_decay(learning_rate, decay_steps, decay_rate,
                             staircase=staircase,
                             end_value=end_learning_rate or None)
  elif schedule == "cosine_decay":
    base = cosine_decay_schedule(
        learning_rate, decay_steps,
        alpha=end_learning_rate / max(learning_rate, 1e-12))
  elif schedule == "linear_decay":
    base = linear_schedule(learning_rate, end_learning_rate, decay_steps)
  else:
    raise ValueError(f"Unknown lr schedule: {schedule!r}")
  if warmup_steps > 0:
    warmup = linear_schedule(0.0, learning_rate, warmup_steps)
    return join_schedules([warmup, base], [warmup_steps])
  return base


@gin.configurable
def create_optimizer(optimizer_name: str = "adam",
                     learning_rate: ScheduleOrFloat = 1e-4,
                     momentum: float = 0.9,
                     beta1: float = 0.9,
                     beta2: float = 0.999,
                     epsilon: float = 1e-8,
                     weight_decay: float = 0.0,
                     gradient_clip_norm: Optional[float] = None,
                     gradient_clip_value: Optional[float] = None,
                     use_lr_schedule: bool = False
                     ) -> GradientTransformation:
  """The JAX package's `create_optimizer`, same arguments and chain.

  `use_lr_schedule=True` takes the rate from `create_lr_schedule()`.
  """
  lr = create_lr_schedule() if use_lr_schedule else learning_rate
  name = optimizer_name.lower()
  if name == "adam":
    opt = chain(scale_by_adam(beta1, beta2, epsilon),
                scale_by_learning_rate(lr))
  elif name == "adamw":
    opt = chain(scale_by_adam(beta1, beta2, epsilon),
                add_decayed_weights(weight_decay),
                scale_by_learning_rate(lr))
  elif name == "sgd":
    opt = chain(_stateless(lambda u, p: u), scale_by_learning_rate(lr))
  elif name == "momentum":
    opt = chain(trace(momentum), scale_by_learning_rate(lr))
  elif name == "rmsprop":
    opt = chain(scale_by_rms(eps=epsilon), scale_by_learning_rate(lr),
                trace(momentum))
  elif name == "adagrad":
    opt = chain(scale_by_rss(eps=epsilon), scale_by_learning_rate(lr))
  elif name == "lamb":
    opt = chain(scale_by_adam(beta1, beta2, epsilon),
                add_decayed_weights(weight_decay), scale_by_trust_ratio(),
                scale_by_learning_rate(lr))
  else:
    raise ValueError(f"Unknown optimizer: {optimizer_name!r}")

  parts = []
  if gradient_clip_norm is not None:
    parts.append(clip_by_global_norm(gradient_clip_norm))
  if gradient_clip_value is not None:
    parts.append(clip(gradient_clip_value))
  if weight_decay and name not in ("adamw", "lamb"):
    parts.append(add_decayed_weights(weight_decay))
  parts.append(opt)
  return chain(*parts) if len(parts) > 1 else opt

