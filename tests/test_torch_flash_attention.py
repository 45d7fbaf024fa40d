"""Port's flash-attention plain version against the JAX package.

The JAX side runs `flash_attention_with_lse` in Pallas interpret mode
with 16×16 blocks, as `tests/test_flash_attention.py` runs it on the
CPU; the same numpy q, k, v go through the port's
`flash_attention_reference` (what the wrapper takes on a CPU tensor and
what `chip_smoke.py` holds the CUDA kernel against on the card).

Tolerances. f32: 1e-5 absolute on out and lse (the same f32 math; the
JAX kernel's online softmax over 16-key tiles and the one-pass plain
version differ only in summation order and rescaling, ~1e-7 here).
bf16 inputs: out 2e-2 absolute — both round p to bf16 before the PV
product, but against different running maxima (per 16-key tile vs the
row max), and out itself is bf16 (one step is 2^-8 relative below
1.0); lse 1e-5 — no bf16 rounding enters it, products of bf16 values
are exact in f32.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention_with_lse as jax_flash_with_lse,
)
from tensor2robot_tpu.parallel import (  # noqa: E402
    attention_reference as jax_attention_reference,
)
from tensor2robot_tpu_torch.layers import transformer  # noqa: E402
from tensor2robot_tpu_torch.parallel import attention_reference  # noqa: E402
from tensor2robot_tpu_torch.parallel.rules import MeshShape  # noqa: E402

# The module (the package exports its function under the same name).
fa = importlib.import_module("tensor2robot_tpu_torch.ops.flash_attention")

_B, _H, _D = 2, 2, 32


def _qkv(t, seed, d=_D):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal((_B, t, _H, d)).astype(np.float32)
          for _ in range(3)]


def _jax(arrays, dtype):
  return [jnp.asarray(a, dtype) for a in arrays]


def _torch(arrays, dtype):
  return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np(x):
  return np.asarray(x.float() if isinstance(x, torch.Tensor)
                    else x.astype(jnp.float32))


# D=16 is the default VRGripper transformer's head dim (width 64, 4 heads).
@pytest.mark.parametrize("d", [32, 16])
@pytest.mark.parametrize("t", [64, 48])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_jax_interpret_f32(causal, t, d):
  arrays = _qkv(t, seed=t + causal, d=d)
  want_out, want_lse = jax_flash_with_lse(
      *_jax(arrays, jnp.float32), causal=causal, block_q=16, block_k=16,
      interpret=True)
  got_out, got_lse = fa.flash_attention_reference(
      *_torch(arrays, torch.float32), causal=causal)
  assert got_out.shape == (_B, t, _H, d) and got_lse.shape == (_B, _H, t)
  assert got_lse.dtype == torch.float32
  np.testing.assert_allclose(_np(got_out), _np(want_out), atol=1e-5, rtol=0)
  np.testing.assert_allclose(_np(got_lse), _np(want_lse), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [32, 16])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_jax_interpret_bf16(causal, d):
  arrays = _qkv(64, seed=7 + causal, d=d)
  want_out, want_lse = jax_flash_with_lse(
      *_jax(arrays, jnp.bfloat16), causal=causal, block_q=16, block_k=16,
      interpret=True)
  got_out, got_lse = fa.flash_attention_reference(
      *_torch(arrays, torch.bfloat16), causal=causal)
  assert got_out.dtype == torch.bfloat16
  np.testing.assert_allclose(_np(got_out), _np(want_out), atol=2e-2, rtol=0)
  np.testing.assert_allclose(_np(got_lse), _np(want_lse), atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
  arrays = _qkv(48, seed=3)
  want = jax_attention_reference(*_jax(arrays, jnp.float32), causal=causal)
  got = attention_reference(*_torch(arrays, torch.float32), causal=causal)
  np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)


def test_wrapper_on_cpu_takes_the_plain_version_without_launching():
  q, k, v = _torch(_qkv(48, seed=4), torch.float32)
  before = fa.flash_attention.launches
  out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
  want_out, want_lse = fa.flash_attention_reference(q, k, v, causal=True)
  assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
  assert torch.equal(fa.flash_attention(q, k, v, causal=True), want_out)
  assert fa.flash_attention.launches == before


def test_causal_rows_ignore_the_future():
  q, k, v = _torch(_qkv(48, seed=5), torch.float32)
  base, _ = fa.flash_attention_reference(q, k, v, causal=True)
  k2, v2 = k.clone(), v.clone()
  k2[:, 30:] += 3.0
  v2[:, 30:] -= 2.0
  pert, _ = fa.flash_attention_reference(q, k2, v2, causal=True)
  assert torch.equal(pert[:, :30], base[:, :30])
  assert (pert[:, 30:] - base[:, 30:]).abs().max() > 1e-3


class _Spy:

  def __init__(self, fn):
    self.fn, self.calls = fn, 0

  def __call__(self, *args, **kwargs):
    self.calls += 1
    return self.fn(*args, **kwargs)


@pytest.mark.parametrize("impl,want", [("auto", "reference"),
                                       ("reference", "reference"),
                                       ("flash", "flash")])
def test_attend_backend_choice_on_cpu(monkeypatch, impl, want):
  """"auto" is flash on a CUDA tensor and the reference on the CPU;
  "flash" always goes through the flash wrapper."""
  spies = {"flash": _Spy(fa.flash_attention),
           "reference": _Spy(attention_reference)}
  monkeypatch.setattr(transformer, "flash_attention", spies["flash"])
  monkeypatch.setattr(transformer, "attention_reference",
                      spies["reference"])
  q, k, v = _torch(_qkv(16, seed=6), torch.float32)
  transformer._attend(q, k, v, impl=impl)
  assert {name: s.calls for name, s in spies.items()} == {
      name: int(name == want) for name in spies}


@pytest.mark.parametrize("kwargs", [
    dict(attention_impl="ring"), dict(attention_impl="ring_flash"),
    dict(moe_experts=4, moe_every=1,
         mesh=MeshShape({"data": 1, "expert": 2}))])
def test_ring_and_moe_raise_naming_the_roadmap_item(kwargs):
  """MoE over a mesh `expert` axis (expert parallelism) is A11; MoE on
  one device is ported. Ring attention is ported
  (tests/test_torch_ring_attention.py): the trunk builds, and without a
  mesh its forward raises JAX's error."""
  if "moe_experts" in kwargs:
    with pytest.raises(NotImplementedError, match="A11"):
      transformer.CausalTransformer(8, width=16, depth=1, num_heads=2,
                                    max_len=8, **kwargs)
    return
  trunk = transformer.CausalTransformer(8, width=16, depth=1, num_heads=2,
                                        max_len=8, dtype=torch.float32,
                                        **kwargs)
  with pytest.raises(ValueError, match="needs a device mesh"):
    trunk(torch.zeros(1, 8, 8))


def test_unknown_impl_raises():
  with pytest.raises(ValueError, match="Unknown attention impl"):
    transformer.CausalTransformer(8, width=16, depth=1, num_heads=2,
                                  max_len=8, attention_impl="xla")


def _bf16_view(shape, pad):
  """A bf16 [B, T, H, D] view whose base sits `pad[0]` elements into its
  buffer and whose rows carry `pad[1]` extra elements."""
  b, t, h, d = shape
  flat = torch.zeros(pad[0] + b * t * (h * d + pad[1]), dtype=torch.bfloat16)
  rows = flat[pad[0]:].view(b, t, h * d + pad[1])
  return rows[..., :h * d].unflatten(-1, (h, d))


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "head_dim_24",
                                 "strides", "bf16_offset", "bf16_stride"])
def test_launch_validates_before_building(bad):
  q, k, v = _torch(_qkv(16, seed=9), torch.float32)
  match = None
  if bad == "dtype":
    q, k, v = (x.half() for x in (q, k, v))
  elif bad.startswith("head_dim"):
    d = 24 if bad == "head_dim_24" else 48
    q, k, v = _torch(_qkv(16, seed=9, d=d), torch.float32)
    match = "head dim"
  elif bad.startswith("bf16"):
    # TMA's rule: a view one element into its buffer (2-byte aligned), or
    # with rows 8 bytes longer than 16-byte multiples.
    k, v = (x.to(torch.bfloat16) for x in (k, v))
    q = _bf16_view(k.shape, (1, 0) if bad == "bf16_offset" else (0, 4))
    assert q.stride(-1) == 1
    match = "TMA"
  else:
    q = q.transpose(-1, -2).contiguous().transpose(-1, -2)
  with pytest.raises(ValueError, match=match):
    fa._launch(q, k, v, causal=False)


def test_bf16_rule_takes_the_model_views_and_size_one_dims():
  """The transformer's q, k, v (slices of one [B, T, 3H, D] tensor) and
  dims of size 1 with odd strides pass TMA's rule; the kernel gets a
  dense stride for a dim of size 1."""
  qkv = torch.zeros((2, 5, 3 * _H, _D), dtype=torch.bfloat16)
  for x in qkv.split(_H, dim=2):
    assert fa._view_strides("q", x) == x.stride()[:3]
  one = torch.zeros((1, 1, 1, _D), dtype=torch.bfloat16).as_strided(
      (1, 1, 1, _D), (3, 5, 7, 1))
  assert fa._view_strides("q", one) == (_D, _D, _D)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_checks_take_every_kernel_head_dim(dtype, d):
  """D ∈ {16, 32, 64, 128} passes `_check_launch` (D=24 and 48 raise in
  `test_launch_validates_before_building`)."""
  q, k, v = _torch(_qkv(16, seed=11, d=d), dtype)
  fa._check_launch(q, k, v)
  fa._check_launch(q, k, v, q)


def test_bf16_rule_takes_the_default_model_head_dim_16_views():
  """The default model's q, k, v (width 64, 4 heads: slices of one
  [B, T, 12, 16] tensor, time stride 384 B, head stride 32 B) meet TMA's
  rule in the forward and are read in place by the backward."""
  qkv = torch.zeros((2, 5, 12, 16), dtype=torch.bfloat16)
  for x in qkv.split(4, dim=2):
    assert x.stride() == (960, 192, 16, 1)
    assert fa._view_strides("q", x) == x.stride()[:3]
    assert fa._bwd_operand(x) is x
  fa._check_launch(*qkv.split(4, dim=2))


def test_backward_copies_a_bf16_operand_outside_the_tma_rule():
  """A dO whose head dim is not dense, or whose base sits off 16 bytes,
  is copied dense (same values) and then meets the rule; an f32 operand
  is read through its strides as it is."""
  do = torch.randn(2, 5, 4, 16).to(torch.bfloat16)
  odd = do.transpose(-1, -2).contiguous().transpose(-1, -2)
  shifted = _bf16_view(do.shape, (1, 0))
  shifted.copy_(do)
  for bad in (odd, shifted):
    assert not fa._meets_tma_rule(bad)
    fixed = fa._bwd_operand(bad)
    assert fixed is not bad and fa._meets_tma_rule(fixed)
    assert torch.equal(fixed, do)
  f32 = odd.float()
  assert fa._bwd_operand(f32) is f32


def test_shapes_must_agree():
  q, k, v = _torch(_qkv(16, seed=10), torch.float32)
  with pytest.raises(ValueError, match="shapes differ"):
    fa.flash_attention(q, k[:, :8], v)
