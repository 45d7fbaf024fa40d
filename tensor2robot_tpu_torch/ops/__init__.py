"""Hand-written Hopper kernels for the port's hot ops, each beside its
plain PyTorch version.

Each wrapper counts its launches in a plain integer, `<wrapper>.launches`
(`launch_counts()` reads them all by name; `counters` keeps them). A
CUDA-graph replay launches kernels without calling the wrappers:
`utils.step_graph` adds the counts that its capture recorded once per
replay. `launch_counts_by_thread()` splits the counts by the thread that
launched.
"""

from typing import Dict

from tensor2robot_tpu_torch.ops.cem_head import (
    fused_cem_head_tail,
    fused_cem_head_tail_reference,
)
from tensor2robot_tpu_torch.ops.cem_select import (
    cem_select_reference,
    fused_cem_select,
    select_elites,
)
from tensor2robot_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_bwd_dkdv,
    flash_attention_bwd_dq,
    flash_attention_reference,
    flash_attention_with_lse,
)
from tensor2robot_tpu_torch.ops import counters

_COUNTERS = {
    "cem_select": fused_cem_select,
    "cem_head_tail": fused_cem_head_tail,
    "flash_attention_fwd": flash_attention,
    "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
}


def launch_counts() -> Dict[str, int]:
  """Every kernel wrapper's launch count, by kernel name."""
  return {name: fn.launches for name, fn in _COUNTERS.items()}


def warmup_launch_counts() -> Dict[str, int]:
  """Launches made by CUDA-graph warm-ups, by kernel name (a part of
  `launch_counts()`)."""
  warm = counters.warmups()
  return {name: warm.get(fn, 0) for name, fn in _COUNTERS.items()}


def launch_counts_by_thread() -> Dict[str, Dict[str, int]]:
  """`launch_counts()` since the last reset, by the name of the thread
  that launched (a graph replay's: the replaying thread's)."""
  names = {fn: name for name, fn in _COUNTERS.items()}
  return {thread: {names[fn]: n for fn, n in counts.items()}
          for thread, counts in counters.by_thread().items()}


def reset_launch_counts() -> None:
  """Sets every count, the warm-up tally and the per-thread split to 0."""
  for fn in _COUNTERS.values():
    fn.launches = 0
  counters.clear_warmups()
  counters.clear_by_thread()


__all__ = ["cem_select_reference", "flash_attention",
           "flash_attention_backward", "flash_attention_backward_reference",
           "flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
           "flash_attention_reference", "flash_attention_with_lse",
           "fused_cem_head_tail", "fused_cem_head_tail_reference",
           "fused_cem_select", "launch_counts", "launch_counts_by_thread",
           "reset_launch_counts",
           "select_elites", "warmup_launch_counts"]
