"""Hand-written Hopper kernels for the port's hot ops, each beside its
plain PyTorch version."""

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
    flash_attention_reference,
    flash_attention_with_lse,
)

__all__ = ["cem_select_reference", "flash_attention",
           "flash_attention_backward", "flash_attention_backward_reference",
           "flash_attention_reference", "flash_attention_with_lse",
           "fused_cem_head_tail", "fused_cem_head_tail_reference",
           "fused_cem_select", "select_elites"]
