"""The PyTorch port imports neither JAX nor anything of the JAX package.

A subprocess imports every module of `tensor2robot_tpu_torch`, then
lists what landed in `sys.modules`. Note the prefix trap: the port's
name starts with "tensor2robot_tpu", so the pin matches that package
exactly and its submodules by the "tensor2robot_tpu." prefix.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN = r"""
def forbidden(m):
    return (m in ("jax", "flax", "tensor2robot_tpu")
            or m.startswith(("jax.", "flax.", "tensor2robot_tpu.")))
"""
exec(_FORBIDDEN)

_PROBE = _FORBIDDEN + r"""
import importlib, pkgutil, sys
import tensor2robot_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if forbidden(m))
print("COUNT=%d" % len(names))
print("BAD=" + ",".join(bad))
"""


def test_port_modules_import_no_jax():
  env = dict(os.environ, PYTHONPATH=_REPO)
  out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  lines = dict(line.split("=", 1) for line in out.stdout.split())
  assert int(lines["COUNT"]) >= 20, out.stdout
  assert lines["BAD"] == "", f"port imported {lines['BAD']}"


@pytest.mark.parametrize("name,bad", [
    ("tensor2robot_tpu_torch", False),
    ("tensor2robot_tpu_torch.ops.cem_select", False),
    ("tensor2robot_tpu", True),
    ("tensor2robot_tpu.ops.cem_select", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib", False),
    ("flax.linen", True),
])
def test_forbidden_matches_packages_not_prefixes(name, bad):
  """The port's own name starts with "tensor2robot_tpu" and must not
  count as the JAX package; the JAX package's modules must."""
  assert forbidden(name) is bad  # noqa: F821 — defined by exec above
