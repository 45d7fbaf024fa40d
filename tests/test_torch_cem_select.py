"""Port's `fused_cem_select` (its plain version, on CPU tensors) against
the JAX kernel in Pallas interpret mode and against `cem_select_lax`.

Mirrors tests/test_cem_select.py's cases on the same numpy inputs:
sigmoid on and off, populations that do not divide the TPU sample
block, tied rows (lax.top_k's lower-index order), the min_std floor,
bf16 operands, and the guards. Tolerances: f32 to 1e-6 (the same f32
products in another summation order); bf16 statistics to 2e-2 and
scores to 1e-2 relative (a hidden activation may round to the other
bf16 neighbour when the two sums differ in the last f32 bit).

The CUDA kernel itself cannot run here (no card, no nvcc); it is held
against this plain version on the H100 by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.ops import cem_select_lax  # noqa: E402
from tensor2robot_tpu.ops import fused_cem_select as jax_fused  # noqa: E402
from tensor2robot_tpu_torch.ops import cem_select  # noqa: E402
from tensor2robot_tpu_torch.ops import fused_cem_select  # noqa: E402

_NAMES = ("mean", "std", "best_action", "best_score")


def _inputs(b=4, p=64, c=32, a=4, seed=0):
  rng = np.random.default_rng(seed)
  pooled = (rng.standard_normal((p, b, c)) * 0.3).astype(np.float32)
  samples = rng.standard_normal((b, p, a)).astype(np.float32)
  dense = tuple(
      ((rng.standard_normal(s) * 0.3).astype(np.float32),
       (rng.standard_normal(s[1]) * 0.3).astype(np.float32))
      for s in ((c, 16), (16, 1)))
  return pooled, samples, dense


def _jax(pooled, samples, dense, dtype=jnp.float32):
  return (jnp.asarray(pooled, dtype), jnp.asarray(samples),
          tuple((jnp.asarray(w, dtype), jnp.asarray(b, dtype))
                for w, b in dense))


def _torch(pooled, samples, dense, dtype=torch.float32):
  t = lambda x: torch.from_numpy(np.asarray(x)).to(dtype)  # noqa: E731
  return (t(pooled), torch.from_numpy(samples),
          tuple((t(w), t(b)) for w, b in dense))


def _assert_matches(got, want, atol=1e-6, rtol=1e-6):
  for g, w, name in zip(got, want, _NAMES):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                               rtol=rtol, err_msg=name)


class TestPlainVersusJax:

  @pytest.mark.parametrize("sigmoid", [False, True])
  def test_matches_interpret_and_lax(self, sigmoid):
    args = _inputs()
    got = fused_cem_select(*_torch(*args), num_elites=6, sigmoid=sigmoid)
    for want in (cem_select_lax(*_jax(*args), num_elites=6,
                                sigmoid=sigmoid),
                 jax_fused(*_jax(*args), num_elites=6, sigmoid=sigmoid,
                           interpret=True)):
      _assert_matches(got, want)

  @pytest.mark.parametrize("p,block_p", [(50, 64), (48, 32), (7, 8),
                                         (65, 64), (33, 16)])
  def test_population_not_a_block_multiple(self, p, block_p):
    """The TPU kernel masks its ragged last block; the port has no
    blocks, and must agree with it wherever the blocks fall."""
    args = _inputs(p=p, seed=p)
    got = fused_cem_select(*_torch(*args), num_elites=5)
    want = jax_fused(*_jax(*args), num_elites=5, block_p=block_p,
                     interpret=True)
    _assert_matches(got, want)
    _assert_matches(got, cem_select_lax(*_jax(*args), num_elites=5))

  def test_tied_rows_take_the_lower_index(self):
    """Rows 2k and 2k+1 share pooled features, so every score ties in
    pairs (across the TPU kernel's block boundaries too)."""
    b, p, c, a = 2, 32, 8, 3
    rng = np.random.default_rng(3)
    base = rng.standard_normal((p // 2, b, c)).astype(np.float32)
    pooled = np.repeat(base, 2, axis=0)
    samples = rng.standard_normal((b, p, a)).astype(np.float32)
    dense = (((rng.standard_normal((c, 1)) * 0.5).astype(np.float32),
              np.zeros((1,), np.float32)),)
    got = fused_cem_select(*_torch(pooled, samples, dense), num_elites=6)
    _assert_matches(got, cem_select_lax(*_jax(pooled, samples, dense),
                                        num_elites=6))
    for block_p in (8, 16, 32):
      _assert_matches(got, jax_fused(*_jax(pooled, samples, dense),
                                     num_elites=6, block_p=block_p,
                                     interpret=True))

  def test_saturated_sigmoid_ties_break_by_index(self):
    """Logits far apart but both saturated: the sigmoid scores tie at
    1.0 and the lower index wins, not the larger logit."""
    b, p, c, a = 1, 8, 1, 2
    pooled = np.arange(p, dtype=np.float32).reshape(p, b, c) + 100.0
    samples = np.arange(b * p * a, dtype=np.float32).reshape(b, p, a)
    dense = ((np.ones((c, 1), np.float32), np.zeros((1,), np.float32)),)
    got = fused_cem_select(*_torch(pooled, samples, dense), num_elites=3,
                           sigmoid=True)
    np.testing.assert_array_equal(got[2].numpy(), samples[:, 0])
    _assert_matches(got, cem_select_lax(*_jax(pooled, samples, dense),
                                        num_elites=3, sigmoid=True))

  def test_min_std_floor(self):
    b, p, c, a = 1, 8, 4, 2
    pooled = np.ones((p, b, c), np.float32)
    samples = np.full((b, p, a), 0.5, np.float32)
    dense = ((np.ones((c, 1), np.float32), np.zeros((1,), np.float32)),)
    got = fused_cem_select(*_torch(pooled, samples, dense), num_elites=3,
                           min_std=0.07)
    np.testing.assert_allclose(got[1].numpy(), 0.07, atol=1e-7)
    np.testing.assert_allclose(got[0].numpy(), 0.5, atol=1e-6)
    _assert_matches(got, jax_fused(*_jax(pooled, samples, dense),
                                   num_elites=3, min_std=0.07,
                                   interpret=True))

  def test_bf16_operands_accumulate_f32(self):
    args = _inputs(seed=5)
    got = fused_cem_select(*_torch(*args, dtype=torch.bfloat16),
                           num_elites=6)
    want = jax_fused(*_jax(*args, dtype=jnp.bfloat16), num_elites=6,
                     interpret=True)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-2, atol=1e-3)
    _assert_matches(got, want, atol=2e-2, rtol=1e-2)
    _assert_matches(got, cem_select_lax(*_jax(*args, dtype=jnp.bfloat16),
                                        num_elites=6), atol=2e-2, rtol=1e-2)


class TestWrapper:

  def test_guards(self):
    pooled, samples, dense = _torch(*_inputs(p=4))
    with pytest.raises(ValueError, match="num_elites"):
      fused_cem_select(pooled, samples, dense, num_elites=5)
    with pytest.raises(ValueError, match="width 1"):
      bad = ((torch.ones(32, 2), torch.zeros(2)),)
      fused_cem_select(pooled, samples, bad, num_elites=2)
    with pytest.raises(ValueError, match="samples"):
      fused_cem_select(pooled, samples[:, :3], dense, num_elites=2)
    with pytest.raises(ValueError, match="chain"):
      bad = ((torch.ones(31, 1), torch.zeros(1)),)
      fused_cem_select(pooled, samples, bad, num_elites=2)

  def test_cpu_takes_plain_version_and_counts_no_launch(self):
    args = _torch(*_inputs())
    before = fused_cem_select.launches
    got = fused_cem_select(*args, num_elites=6)
    want = cem_select.cem_select_reference(*args, num_elites=6)
    assert fused_cem_select.launches == before
    for g, w in zip(got, want):
      torch.testing.assert_close(g, w, rtol=0, atol=0)

  def test_other_devices_never_reach_the_plain_version(self, monkeypatch):
    """Only a CPU tensor takes the plain version; anything else goes to
    the kernel path or raises."""
    monkeypatch.setattr(cem_select, "cem_select_reference",
                        lambda *a, **k: pytest.fail("plain version used"))
    pooled, samples, dense = _torch(*_inputs())
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
      fused_cem_select(meta(pooled), meta(samples),
                       tuple((meta(w), meta(b)) for w, b in dense),
                       num_elites=6)


class TestPlan:
  """`_plan`, the kernel's dispatch rule, pinned without a card: which
  shapes take version 2 (`wgmma`), which keep version 1 (CUDA cores),
  which raise before anything is built."""

  @pytest.mark.parametrize("p,widths,dtype,elites,path", [
      (64, (64, 64, 64, 1), torch.bfloat16, 6, "wgmma"),    # main path
      (200, (64, 64, 64, 1), torch.bfloat16, 6, "wgmma"),   # four tiles
      (50, (64, 64, 64, 1), torch.bfloat16, 6, "wgmma"),    # ragged tile
      (64, (16, 48, 1), torch.bfloat16, 6, "wgmma"),        # padded hidden
      (64, (256, 256, 16, 1), torch.bfloat16, 64, "wgmma"),
      (64, (64, 64, 64, 1), torch.float32, 6, "cuda_cores"),  # f32
      (64, (64, 1), torch.bfloat16, 5, "cuda_cores"),       # no hidden
      (64, (48, 64, 1), torch.bfloat16, 6, "cuda_cores"),   # C not 2^k
      (64, (64, 40, 1), torch.bfloat16, 6, "cuda_cores"),   # width % 16
      (64, (64, 272, 1), torch.bfloat16, 6, "cuda_cores"),  # width > 256
      (128, (64, 64, 1), torch.bfloat16, 65, "cuda_cores"),  # E > 64
      (64, (8, 16, 1), torch.bfloat16, 6, "cuda_cores"),    # C < 16
  ], ids=lambda v: str(v))
  def test_path(self, p, widths, dtype, elites, path):
    assert cem_select._plan(p, widths, dtype, elites, 4)["path"] == path

  def test_main_path_bytes(self):
    """Version 2's layout at the serving / Bellman shape, by hand: the
    pooled tile 8,192 B; the q-head's two 64×64 bf16 tiles 16,384 B, two
    f32 biases 512 B, the last column and bias 272 B; 128 candidates'
    scores and indices and two mbarriers 1,040 B; the samples 1,024 B;
    1,024 B of alignment."""
    plan = cem_select._plan(64, (64, 64, 64, 1), torch.bfloat16, 6, 4)
    assert plan == {"path": "wgmma",
                    "smem": 8192 + 16384 + 512 + 272 + 1040 + 1024 + 1024}
    # Two stages of 8,192 B once P passes one tile, and P·A·4 samples.
    two = cem_select._plan(200, (64, 64, 64, 1), torch.bfloat16, 6, 4)
    assert two["smem"] == plan["smem"] + 8192 + (200 - 64) * 16

  @pytest.mark.parametrize("p,widths,dtype,match", [
      (64, (64, 64, 1), torch.float16, "dtype"),
      (64, (64,) + (16,) * 8 + (1,), torch.bfloat16, "layers"),
      (4096, (256, 256, 256, 1), torch.bfloat16, "shared memory"),
      (20000, (64, 64, 1), torch.float32, "shared memory"),
  ], ids=["fp16", "nine_layers", "too_wide_bf16", "too_many_f32"])
  def test_raises_before_building(self, p, widths, dtype, match,
                                  monkeypatch):
    monkeypatch.setattr(cem_select.build, "load",
                        lambda *a, **k: pytest.fail("built"))
    with pytest.raises(ValueError, match=match):
      cem_select._plan(p, widths, dtype, 6, 4)
    pooled = torch.zeros((p, 1, widths[0]), dtype=dtype)
    samples = torch.zeros((1, p, 4))
    dense = tuple((torch.zeros((i, o), dtype=dtype),
                   torch.zeros((o,), dtype=dtype))
                  for i, o in zip(widths[:-1], widths[1:]))
    with pytest.raises(ValueError, match=match):
      cem_select._launch(pooled, samples, dense, 6, 1e-2, False)

  def test_q_network_operands_take_the_wgmma_path(self):
    """`GraspingQModel()`'s real pooled features and q-head (full width,
    bf16, on the CPU) take version 2 and meet its alignment."""
    from tensor2robot_tpu_torch.research.qtopt import networks
    from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
        GraspingQModel,
    )
    model = GraspingQModel()
    network = model.bind(model.create_inference_state(seed=0, device="cpu"))
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), np.uint8))
    actions = torch.from_numpy(
        rng.uniform(-1, 1, (2, 64, 4)).astype(np.float32))
    with torch.no_grad():
      pooled = network.pool_population(network.encode(image), {}, actions)
    dense = networks.q_head_dense_params(network, dtype=network.dtype)
    widths = [pooled.shape[-1]] + [w.shape[1] for w, _ in dense]
    assert pooled.dtype == torch.bfloat16 and pooled.is_contiguous()
    assert cem_select._plan(64, widths, pooled.dtype, 6, 4)["path"] == \
        "wgmma"
    for t in [pooled] + [w for w, _ in dense]:
      assert cem_select._aligned16(t) is t
