"""The port's sharding rules seam (`parallel/rules.py`) against the JAX
package's, on the JAX tests' 8-device virtual CPU mesh.

  * Every family table over the JAX families' canonical param templates,
    on pod-only, fsdp, data × fsdp, fsdp × model, model, expert × fsdp and
    stage × fsdp meshes: the port's spec for each flax path equals JAX's.
  * The port's own params: `models.convert.flax_param_paths` names every
    param of the QT-Opt network and of the VRGripper regression and MoE
    transformer models by the JAX model's flax path, and
    `match_state_rules` over them gives the JAX specs; on a pod-only
    mesh, the replicated spec everywhere.
  * The engine cases of `tests/test_sharding_rules.py`: first match wins,
    a literal spec is used as it is, an unmatched leaf raises, an unknown
    family raises, an indivisible stacked weight raises.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JaxP  # noqa: E402

from tensor2robot_tpu.parallel import create_mesh  # noqa: E402
from tensor2robot_tpu.parallel import rules as jax_rules  # noqa: E402
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.parallel import rules  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import GraspingQModel  # noqa: E402
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    VRGripperRegressionModel,
    VRGripperTransformerModel,
)

_MESHES = ({"pod": 1}, {"pod": 8}, {"fsdp": 8}, {"data": 2, "fsdp": 4},
           {"fsdp": 4, "model": 2}, {"model": 8}, {"expert": 4, "fsdp": 2},
           {"stage": 2, "fsdp": 4})


@functools.lru_cache(maxsize=None)
def _templates(family):
  """The JAX family's canonical param trees, flattened to flax paths."""
  return [{jax_rules.tree_path_str(path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
          for tree in jax_rules.family_param_templates(family)]


def _jax_mesh(axes):
  """A JAX mesh of `axes` over the first devices it needs."""
  return create_mesh(dict(axes),
                     devices=jax.devices()[:int(np.prod(list(axes.values())))])


def _jax_specs(family, flat, axes):
  mesh = _jax_mesh(axes)
  specs = jax_rules.match_partition_rules(
      jax_rules.family_rules(family), flat, mesh)
  return {path: tuple(spec) for path, spec in specs.items()}


def test_the_tables_are_the_jax_tables():
  assert sorted(rules.FAMILY_RULES) == sorted(jax_rules.FAMILY_RULES)
  for family, table in rules.FAMILY_RULES.items():
    want = jax_rules.FAMILY_RULES[family]
    assert [p for p, _ in table] == [p for p, _ in want], family
    for (_, got), (_, placement) in zip(table, want):
      assert type(got).__name__ == type(placement).__name__, family
      assert vars(got) == vars(placement), family


@pytest.mark.parametrize("axes", _MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
@pytest.mark.parametrize("family", sorted(jax_rules.FAMILY_RULES))
def test_family_specs_match_jax(family, axes):
  mesh = rules.MeshShape(axes)
  for flat in _templates(family):
    try:
      want = _jax_specs(family, flat, axes)
    except ValueError as e:  # an indivisible stacked weight
      with pytest.raises(ValueError, match="not divisible"):
        rules.match_partition_rules(rules.family_rules(family), flat, mesh)
      assert "not divisible" in str(e)
      continue
    got = rules.match_partition_rules(rules.family_rules(family), flat,
                                      mesh)
    assert {k: tuple(v) for k, v in got.items()} == want
    if set(axes) == {"pod"}:
      assert all(spec == rules.P() for spec in got.values())


def _port_models(family):
  """The port's counterparts of the first JAX templates of `family`."""
  if family == "qtopt":
    return [GraspingQModel(image_size=16, torso_filters=(8,),
                           head_filters=(8,), dense_sizes=(16,),
                           action_dim=2)]
  return [VRGripperRegressionModel(),
          VRGripperTransformerModel(moe_experts=4, moe_every=2)]


@pytest.mark.parametrize("family", ["qtopt", "vrgripper"])
def test_port_params_carry_the_flax_paths(family):
  for model, flat in zip(_port_models(family), _templates(family)):
    network = model.create_network()
    paths = convert.flax_param_paths(network)
    assert set(paths) == set(dict(network.named_parameters()))
    assert set(paths.values()) == set(flat)
    shapes = convert.flax_param_shapes(network)
    for name in paths:
      assert shapes[name] == tuple(flat[paths[name]].shape), name


@pytest.mark.parametrize("axes", [{"pod": 1}, {"pod": 8},
                                  {"fsdp": 4, "model": 2},
                                  {"expert": 4, "fsdp": 2}],
                         ids=lambda a: "x".join(
                             f"{k}{v}" for k, v in a.items()))
@pytest.mark.parametrize("family", ["qtopt", "vrgripper"])
def test_state_rules_over_converted_params_match_jax(family, axes):
  """`match_state_rules` over the port's own state (torch names, torch
  layouts) gives, name by name, JAX's spec for the param's flax path."""
  for model, flat in zip(_port_models(family), _templates(family)):
    want = _jax_specs(family, flat, axes)
    network = model.create_network()
    paths = convert.flax_param_paths(network)
    params = model.create_inference_state(device="cpu").params
    got = rules.match_state_rules(rules.family_rules(family), params,
                                  network, rules.MeshShape(axes))
    assert set(got) == set(params)
    for name, spec in got.items():
      assert tuple(spec) == want[paths[name]], name
      if set(axes) == {"pod"}:
        assert spec == rules.P()


# ---- the engine (tests/test_sharding_rules.py's cases) ----

_DATA_FSDP = {"data": 2, "fsdp": 4}


def _both(table, jax_table, tree, axes, **kw):
  got = rules.match_partition_rules(table, tree, rules.MeshShape(axes), **kw)
  want = jax_rules.match_partition_rules(jax_table, tree,
                                         _jax_mesh(axes), **kw)
  return ({k: tuple(v) for k, v in got.items()},
          {k: tuple(v) for k, v in want.items()})


def test_first_match_wins_and_placements_resolve():
  tree = {"torso/kernel": jnp.zeros((8, 16)), "torso/bias": jnp.zeros((16,))}
  got, want = _both(
      ((r"/bias$", rules.Replicate()), (r".*", rules.ShardLargest("fsdp"))),
      ((r"/bias$", jax_rules.Replicate()),
       (r".*", jax_rules.ShardLargest("fsdp"))),
      tree, _DATA_FSDP, min_size_to_shard=1)
  assert got == want == {"torso/bias": (), "torso/kernel": (None, "fsdp")}


def test_literal_partition_spec_used_verbatim():
  got, want = _both(((r".*", rules.P("data")),), ((r".*", JaxP("data")),),
                    {"w": jnp.zeros((4, 4))}, _DATA_FSDP)
  assert got == want == {"w": ("data",)}
  # A JAX spec in a port table reads the same.
  got = rules.match_partition_rules(((r".*", JaxP("data")),),
                                    {"w": jnp.zeros((4, 4))},
                                    rules.MeshShape(_DATA_FSDP))
  assert got == {"w": rules.P("data")}


def test_small_leaves_and_ties_follow_jax():
  tree = {"a": jnp.zeros((8, 8)), "b": jnp.zeros((4, 2)),
          "c": jnp.zeros((6, 3)), "d": jnp.zeros(())}
  for min_size in (1, 64, 1024):
    got, want = _both(((r".*", rules.ShardLargest("fsdp")),),
                      ((r".*", jax_rules.ShardLargest("fsdp")),),
                      tree, _DATA_FSDP, min_size_to_shard=min_size)
    assert got == want


def test_unmatched_leaf_raises():
  for fn, table, mesh in (
      (rules.match_partition_rules, ((r"/bias$", rules.Replicate()),),
       rules.MeshShape(_DATA_FSDP)),
      (jax_rules.match_partition_rules,
       ((r"/bias$", jax_rules.Replicate()),), _jax_mesh(_DATA_FSDP))):
    with pytest.raises(ValueError, match="no partition rule matched"):
      fn(table, {"w": jnp.zeros((4,))}, mesh)


def test_unknown_family_raises():
  for fn in (rules.family_rules, jax_rules.family_rules):
    with pytest.raises(ValueError, match="unknown model family 'nope'"):
      fn("nope")


def test_indivisible_stacked_weight_raises():
  tree = {"trunk/block1/moe/moe_expert_w_in": jnp.zeros((4, 8, 16))}
  for fn, table, mesh in (
      (rules.match_partition_rules, rules.family_rules("vrgripper"),
       rules.MeshShape({"expert": 8})),
      (jax_rules.match_partition_rules, jax_rules.family_rules("vrgripper"),
       _jax_mesh({"expert": 8}))):
    with pytest.raises(ValueError, match="not divisible"):
      fn(table, tree, mesh)
