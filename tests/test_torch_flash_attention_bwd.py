"""Port's flash-attention backward against the JAX package.

The JAX side is `jax.vjp` of `flash_attention_with_lse` with its Pallas
kernels (forward, `_dkdv_kernel`, `_dq_kernel`) in interpret mode on
16×16 blocks, as `tests/test_flash_attention.py` runs them on the CPU.
The port's plain backward `flash_attention_backward_reference` gets the
same numpy q, k, v, cotangents and the JAX forward's out and lse, so
only the backward is compared. Then the port's `FlashAttention`
autograd Function (what `flash_attention` runs when autograd records)
is held against the plain backward and against autodiff through a
materialized softmax.

Tolerances, as the largest |error| over max(1, largest |value|) of each
gradient (values range over ~0.01–4 here). f32: 1e-5 (the same f32 math
in other summation orders, ~1e-6 here). bf16: 2e-2 — both round p and
ds to bf16 from f32 scores that differ in summation order, so a
rounding may land on the other bf16 neighbour, and the gradients are
stored in bf16 (one step is 2^-8 relative below 1).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention_with_lse as jax_flash_with_lse,
)
from tensor2robot_tpu_torch.layers import CausalTransformer  # noqa: E402

fa = importlib.import_module("tensor2robot_tpu_torch.ops.flash_attention")

_B, _H, _D = 2, 2, 32
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _arrays(t, seed, d=_D):
  rng = np.random.default_rng(seed)
  qkvdo = [rng.standard_normal((_B, t, _H, d)).astype(np.float32)
           for _ in range(4)]
  return qkvdo, rng.standard_normal((_B, _H, t)).astype(np.float32)


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, tol):
  got, want = _np(got), _np(want)
  scale = max(1.0, float(np.abs(want).max()))
  np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


_JAX_VJP = {}


def _jax_vjp(causal):
  """jit(forward + vjp) of the Pallas kernels, one compile per config."""
  if causal not in _JAX_VJP:
    def fn(q, k, v, do, dlse):
      (out, lse), vjp = jax.vjp(
          lambda q, k, v: jax_flash_with_lse(
              q, k, v, causal=causal, block_q=16, block_k=16,
              interpret=True), q, k, v)
      return out, lse, vjp((do, dlse))
    _JAX_VJP[causal] = jax.jit(fn)
  return _JAX_VJP[causal]


# D=16 is the default VRGripper transformer's head dim (width 64, 4 heads).
@pytest.mark.parametrize("d", [32, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dlse", ["zero", "random"])
@pytest.mark.parametrize("t", [64, 48])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax_interpret(causal, t, dlse, dtype, d):
  (q, k, v, do), g_lse = _arrays(t, seed=t + 2 * causal, d=d)
  if dlse == "zero":
    g_lse = np.zeros_like(g_lse)
  jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
  out, lse, want = _jax_vjp(causal)(
      *(jnp.asarray(x, jdt) for x in (q, k, v, do)), jnp.asarray(g_lse))
  to_t = lambda x: torch.from_numpy(_np(x)).to(tdt)  # noqa: E731
  got = fa.flash_attention_backward_reference(
      *(to_t(x) for x in (q, k, v)), to_t(out),
      torch.from_numpy(_np(lse)), to_t(do),
      None if dlse == "zero" else torch.from_numpy(g_lse), causal=causal)
  for g, w in zip(got, want):
    assert g.dtype == tdt and g.shape == (_B, t, _H, d)
    _assert_close(g, w, _TOL[dtype])


def _leaves(t, seed, dtype=torch.float32):
  (q, k, v, do), g_lse = _arrays(t, seed)
  qkv = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
  return qkv, torch.from_numpy(do).to(dtype), torch.from_numpy(g_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_on_cpu_is_the_plain_backward(causal, dtype):
  """The Function runs the plain forward and the plain backward on CPU
  tensors, and launches nothing; both cotangents flow."""
  qkv, do, g_lse = _leaves(40, seed=3 + causal, dtype=dtype)
  counts = [f.launches for f in (fa.flash_attention,
                                 fa.flash_attention_bwd_dkdv,
                                 fa.flash_attention_bwd_dq)]
  out, lse = fa.flash_attention_with_lse(*qkv, causal=causal)
  assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
  got = torch.autograd.grad((out, lse), qkv, (do, g_lse))
  want = fa.flash_attention_backward_reference(
      *(x.detach() for x in qkv), out.detach(), lse.detach(), do, g_lse,
      causal=causal)
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  assert counts == [f.launches for f in (fa.flash_attention,
                                         fa.flash_attention_bwd_dkdv,
                                         fa.flash_attention_bwd_dq)]


def test_missing_cotangents_count_as_zeros():
  """Only out used: dlse is None (zeros). Only lse used: dO is zeros."""
  qkv, do, g_lse = _leaves(24, seed=5)
  out, lse = fa.flash_attention_with_lse(*qkv, causal=True)
  base = (out.detach(), lse.detach())
  only_out = torch.autograd.grad(fa.flash_attention(*qkv, causal=True), qkv,
                                 do)
  want = fa.flash_attention_backward_reference(
      *(x.detach() for x in qkv), *base, do, torch.zeros_like(g_lse),
      causal=True)
  for g, w in zip(only_out, want):
    torch.testing.assert_close(g, w, atol=0, rtol=0)
  only_lse = torch.autograd.grad(lse, qkv, g_lse)
  want = fa.flash_attention_backward_reference(
      *(x.detach() for x in qkv), *base, torch.zeros_like(do), g_lse,
      causal=True)
  for g, w in zip(only_lse, want):
    torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_gradients_match_autodiff_of_a_materialized_softmax(causal):
  """The port's counterpart of the JAX package's
  `test_lse_gradients_match_reference`: a loss of both outputs, against
  autodiff through softmax + logsumexp (same tolerance, 5e-5)."""
  qkv, _, _ = _leaves(32, seed=7)

  def ref_loss(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(_D)
    if causal:
      s = s.masked_fill(~torch.ones(32, 32, dtype=torch.bool).tril(), -1e30)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), v)
    return (out ** 2).sum() + torch.sin(lse).sum()

  out, lse = fa.flash_attention_with_lse(*qkv, causal=causal)
  got = torch.autograd.grad((out ** 2).sum() + torch.sin(lse).sum(), qkv)
  want = torch.autograd.grad(ref_loss(*qkv), qkv)
  for g, w in zip(got, want):
    torch.testing.assert_close(g, w, atol=5e-5, rtol=5e-5)


def test_flash_trunk_carries_bf16_gradients_to_f32_masters():
  """A bf16 trunk on the flash path: every master weight gets an f32
  gradient (flax's nn.Dense(dtype=bf16) cotangents come back the same
  way), and it equals the reference backend's to bf16 rounding."""
  x = torch.from_numpy(np.random.default_rng(8).standard_normal(
      (2, 16, 8)).astype(np.float32))
  grads = {}
  for impl in ("flash", "reference"):
    torch.manual_seed(0)
    net = CausalTransformer(8, width=32, depth=1, num_heads=1, max_len=16,
                            attention_impl=impl, dtype=torch.bfloat16)
    with torch.no_grad():
      for p in net.parameters():
        p.copy_(torch.randn_like(p) * 0.2)
    net(x).square().sum().backward()
    grads[impl] = {k: p.grad for k, p in net.named_parameters()}
  for name, g in grads["flash"].items():
    assert g.dtype == torch.float32, name
    assert g.abs().max() > 0, name
    _assert_close(g, grads["reference"][name], 5e-2)


def test_backward_launch_validates_before_building():
  (q, k, v, do), _ = _arrays(16, seed=9)
  q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
  lse = torch.zeros(_B, _H, 16)
  with pytest.raises(ValueError, match="share one dtype"):
    fa._launch_bwd(False, q, k, v, do.double(), lse, lse, True)
  with pytest.raises(ValueError, match="lse must be"):
    fa._launch_bwd(False, q, k, v, do, lse.transpose(1, 2), lse, True)
  with pytest.raises(ValueError, match="unsupported device"):
    fa._launch_bwd(True, q, k, v, do, lse, lse, True)
