"""Captured steps: the port's counterpart of the JAX package's compiled
dispatch (`train_eval._compile_steps` and the AOT executables behind
`_checked_aot`, the K-step `lax.scan`, one serving executable per bucket).

On the card a program that the JAX package compiles once and dispatches
many times is captured once into a `torch.cuda.CUDAGraph` and replayed:
one host launch per dispatch instead of hundreds. `StepGraph` is the one
helper every graphed path uses:

    graph = StepGraph(fn, carry, inputs, device, num_generators=K)
    outputs = graph.replay(new_inputs)       # after seeding graph.generators

`fn(carry, inputs, generators) -> (new_carry, outputs)` is a step over
trees of tensors (dicts, named tuples, dataclasses such as `TrainState`).
The helper

  * allocates static buffers: a copy of `carry` (the state the graph
    carries from replay to replay) and buffers shaped like `inputs`;
  * runs `fn` `warmup` times on a side stream, its results dropped (every
    kernel library is built and loaded there, and every library's
    once-per-process call made: no compile or opt-in runs inside a
    capture), then captures one call into a graph with its own memory
    pool; at the end of the captured region one `_foreach_copy_` writes
    the new carry into the static carry, so the next replay reads it;
  * registers `generators` (one CUDA generator each) with the graph, so a
    replay draws from each generator's seed and offset as they stand:
    seeding one before a replay gives the numbers that an eager call
    with a generator seeded alike draws;
  * on `replay(inputs)` copies new inputs into the static buffers,
    replays, and returns copies of the outputs (nothing the caller holds
    aliases a static buffer); `carry_copy()` returns a copy of the carry.

`GraphCache` keeps one `StepGraph` per input signature over one carry,
as jit keeps one executable per shape (`train_eval`'s train and eval
steps).

Rules it keeps:
  * One buffer discipline on both devices. On the CPU `replay` runs `fn`
    eagerly over the same static buffers and copies the carry back the
    same way; there is no capture (what a caller asking for the CPU gets).
  * No fallback. On a CUDA device a failed capture or replay raises.
  * No collection inside a capture. Python's cyclic garbage collector is
    held off while a capture runs: a collection there runs the
    destructors of dead objects on the capturing thread, and a dead
    `CUDAGraph`'s destructor makes a CUDA call that a capture does not
    permit, which invalidates the capture (its error shows only at the
    capture's end).
  * Launch counters stay right. The kernel wrappers count launches in
    Python, which a replay does not run: the capture (which launches
    nothing) records the counts of its stream instead of adding them
    (`ops.counters.recording`), and each replay adds them once. Warm-up
    calls launch for real and count, tallied apart as well
    (`ops.warmup_launch_counts()`).
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

from tensor2robot_tpu_torch.ops import counters
from tensor2robot_tpu_torch.utils import tree

StepFn = Callable[[Any, Any, Sequence[torch.Generator]], Any]


_GC_LOCK = threading.Lock()
_GC_HOLDS = 0
_GC_WAS_ENABLED = False


@contextlib.contextmanager
def collector_held() -> Iterator[None]:
  """Holds Python's cyclic garbage collector off while a capture runs
  (`StepGraph` and any other capture in the port wrap it in this).

  A collection runs the destructors of dead objects on the thread that
  triggered it, the capturing one included, and a dead `CUDAGraph`'s
  destructor makes a CUDA call that a capture does not permit. Nested
  and concurrent holds keep it off until the last one ends; it comes
  back on only if it was on before the first."""
  global _GC_HOLDS, _GC_WAS_ENABLED
  with _GC_LOCK:
    if _GC_HOLDS == 0:
      _GC_WAS_ENABLED = gc.isenabled()
      gc.disable()
    _GC_HOLDS += 1
  try:
    yield
  finally:
    with _GC_LOCK:
      _GC_HOLDS -= 1
      if _GC_HOLDS == 0 and _GC_WAS_ENABLED:
        gc.enable()


def tensors(state: Any) -> List[torch.Tensor]:
  """The tensor leaves of a tree, in structure order."""
  return [x for x in tree.leaves(state) if isinstance(x, torch.Tensor)]


def map_tensors(fn: Callable[[torch.Tensor], Any], state: Any) -> Any:
  """`fn` over a tree's tensor leaves; other leaves stay as they are."""
  return tree.map_structure(
      lambda x: fn(x) if isinstance(x, torch.Tensor) else x, state)


def copy_tree(state: Any) -> Any:
  """A copy of every tensor leaf (fresh, contiguous storage), as
  multi-tensor copies."""
  leaves = tensors(state)
  fresh = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in leaves]
  copy_into(fresh, leaves)
  it = iter(fresh)
  return map_tensors(lambda _: next(it), state)


def copy_into(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]
              ) -> None:
  """dst[i] ← src[i] for every pair (shapes must match; each dst
  contiguous), one multi-tensor copy per pair of dtypes. Both sides go
  flat, so that sizes and strides agree: a list of mixed dtypes, sizes
  or strides would copy tensor by tensor."""
  if len(dst) != len(src):
    raise ValueError(f"{len(src)} tensors for {len(dst)} buffers")
  groups: Dict[tuple, tuple] = {}
  for d, s in zip(dst, src):
    if d.shape != s.shape:
      raise ValueError(f"a {tuple(s.shape)} tensor for a "
                       f"{tuple(d.shape)} buffer")
    ds, ss = groups.setdefault((d.dtype, s.dtype, s.device), ([], []))
    ds.append(d.view(-1))
    ss.append(s.reshape(-1))
  for ds, ss in groups.values():
    torch._foreach_copy_(ds, ss)


def input_signature(inputs: Any) -> tuple:
  """(shape, dtype) of every tensor leaf: inputs with the same signature
  can share one graph's static buffers."""
  return tuple((tuple(t.shape), t.dtype) for t in tensors(inputs))


class StepGraph:
  """One step, captured once on a CUDA device and replayed (run eagerly
  over the same static buffers on the CPU)."""

  def __init__(self, fn: StepFn, carry: Any, inputs: Any,
               device: torch.device, num_generators: int = 0,
               carries: bool = True, warmup: int = 1,
               own_carry: bool = True,
               generators: Sequence[torch.Generator] = ()):
    """Args:
      fn: `(carry, inputs, generators) -> (new_carry, outputs)`.
      carry: the state the step carries (copied into static buffers).
      inputs: example inputs (their shapes and dtypes; copied in).
      device: where the buffers live; CUDA captures, the CPU runs eagerly.
      num_generators: generators `fn` draws from, `self.generators`.
      carries: False for a step whose carry is only read (an eval step):
        no copy back.
      warmup: eager calls on a side stream before the capture (CUDA).
      own_carry: False reads `carry`'s own tensors (already on `device`)
        as the static carry instead of copying them: several graphs can
        then share one state that their owner rewrites between replays.
      generators: generators of the caller's that `fn` draws from (a
        model's dropout generator), registered with the graph after the
        `num_generators` new ones.
    """
    self._fn = fn
    self._device = torch.device(device)
    self._carries = carries
    self.carry = (copy_tree(map_tensors(lambda t: t.to(self._device), carry))
                  if own_carry else carry)
    self.inputs = copy_tree(map_tensors(lambda t: t.to(self._device), inputs))
    self._input_leaves = tensors(self.inputs)
    self.generators = [torch.Generator(device=self._device)
                       for _ in range(num_generators)] + list(generators)
    self.replays = 0
    self._launches_per_replay: Dict[Callable, int] = {}
    self._graph: Optional[torch.cuda.CUDAGraph] = None
    self._outputs: Any = None
    if self._device.type == "cuda":
      self._capture(warmup)

  @property
  def captured(self) -> bool:
    return self._graph is not None

  def _step(self) -> Any:
    new_carry, outputs = self._fn(self.carry, self.inputs, self.generators)
    if self._carries:
      # A leaf the step wrote in place (a replay ring) is its own new
      # value: no copy.
      pairs = [(d, s) for d, s in zip(tensors(self.carry),
                                      tensors(new_carry)) if d is not s]
      copy_into([d for d, _ in pairs], [s for _, s in pairs])
    return outputs

  def _capture(self, warmup: int) -> None:
    side = torch.cuda.Stream(self._device)
    side.wait_stream(torch.cuda.current_stream(self._device))
    with torch.cuda.stream(side), counters.recording(side) as launched:
      for _ in range(warmup):
        self._fn(self.carry, self.inputs, self.generators)
    counters.add(launched, warmup=True)  # the warm-up's launches ran
    torch.cuda.current_stream(self._device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for generator in self.generators:
      graph.register_generator_state(generator)
    capture = torch.cuda.Stream(self._device)
    # thread_local: other threads (a server's dispatches of buckets
    # already captured) may use the card while this thread captures.
    with torch.cuda.device(self._device), counters.recording(
        capture) as launched, collector_held():
      with torch.cuda.graph(graph, stream=capture,
                            capture_error_mode="thread_local"):
        self._outputs = self._step()
    self._launches_per_replay = launched
    self._graph = graph

  def set_carry(self, state: Any) -> None:
    """Copies `state`'s tensors (same structure) into the static carry."""
    copy_into(tensors(self.carry),
              [t.to(self._device) for t in tensors(state)])

  def carry_copy(self) -> Any:
    """A copy of the static carry that no replay writes."""
    return copy_tree(self.carry)

  def replay(self, inputs: Any = None) -> Any:
    """Copies `inputs` (the example's structure and shapes; None keeps
    the static inputs as they are) into the static buffers, runs the
    step once, and returns copies of its outputs."""
    if inputs is not None:
      copy_into(self._input_leaves, tensors(inputs))
    if self._graph is not None:
      self._graph.replay()
      counters.add(self._launches_per_replay)
      outputs = self._outputs
    else:
      outputs = self._step()
    self.replays += 1
    return copy_tree(outputs)


class GraphCache:
  """One `StepGraph` per input signature, as jit keeps one executable per
  input shape, over one carry: inputs of a signature seen before replay
  its graph; a new signature captures a graph of its own. A graph first
  takes the newest carry when another graph (or `load`) last wrote it."""

  def __init__(self, fn: StepFn, carry: Any, device: torch.device,
               **graph_kwargs):
    """`carry` is the first newest carry; `graph_kwargs` go to each
    `StepGraph` (`carries=False` for a step that only reads it)."""
    self._fn = fn
    self._device = device
    self._kwargs = graph_kwargs
    self._carries = graph_kwargs.get("carries", True)
    self._graphs: Dict[tuple, StepGraph] = {}
    self._newest = carry
    self._holders: set = set()  # graphs whose static carry is the newest

  def load(self, carry: Any) -> None:
    """Makes `carry` the newest carry."""
    self._newest = carry
    self._holders = set()

  def replay(self, inputs: Any) -> Any:
    """The step over `inputs` and the newest carry, by the graph of
    `inputs`' signature; returns copies of its outputs."""
    signature = input_signature(inputs)
    graph = self._graphs.get(signature)
    if graph is None:
      graph = StepGraph(self._fn, self._newest, inputs, self._device,
                        **self._kwargs)
      self._graphs[signature] = graph
    elif graph not in self._holders:
      graph.set_carry(self._newest)
    outputs = graph.replay(inputs)
    if self._carries:
      self._newest, self._holders = graph.carry, {graph}
    else:
      self._holders.add(graph)
    return outputs

  def carry_copy(self) -> Any:
    """A copy of the newest carry that no replay writes."""
    return copy_tree(self._newest)
