"""Data-side definitions the port needs so far (the `Mode` enum)."""

from tensor2robot_tpu_torch.data.abstract_input_generator import Mode

__all__ = ["Mode"]
