"""PyTorch/CUDA port of tensor2robot_tpu, slice by slice.

The JAX package `tensor2robot_tpu` is the reference; this package keeps
its module layout and public names so each module's counterpart is easy
to find. It imports torch and numpy only — never jax, flax or anything
of the JAX package (pinned by tests/test_torch_imports.py).

Entry points (`QTOptLearner`, `BucketedServingEngine`,
`CEMPolicyServer`, `train_eval.train_eval_model`) run on the CUDA card
unless the caller passes ``device="cpu"``; they raise when CUDA is
requested and absent.
"""

from tensor2robot_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
