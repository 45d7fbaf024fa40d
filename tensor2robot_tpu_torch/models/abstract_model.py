"""Model base and carried state (port of `models/abstract_model.py`).

`TrainState` holds a network's parameters, batch statistics and
optimizer state. The model base has the inference half (`device_dtype`,
`preprocessor`, `create_network`, `predict_step`), the train half
(`create_train_state`, `loss_fn`, `train_grads`, `apply_gradients`,
`train_step`) and `eval_step`. The JAX package keeps params outside its stateless flax
modules; the port does the same, so a state can be hot-swapped
atomically while a dispatch still runs on the old one.
`AbstractT2RModel.bind(state)` returns a module whose tensors ARE the
state's (no copy), built once per state object; training calls one
meta-device module through `torch.func.functional_call` over the
state's tensors, and every step returns a new state (nothing is
updated in place), as the JAX step does.

A network with batch norm trains on its batch statistics: `loss_fn`
passes params and running statistics to `functional_call` and returns
the new running statistics (`mutable=["batch_stats"]` under flax),
which `apply_gradients` stores; the old state's buffers are never
written.

An auxiliary loss that a network returns under `AUX_LOSS_OUTPUT` is
popped before `model_train_fn` / `model_eval_fn` see the outputs and
weighted into the loss by `aux_loss_weight`, reported as `aux_loss`, in
every mode, and stripped from `predict_step`'s outputs, as the JAX
package does (the VRGripper transformer's MoE trunk returns one).

Under `utils.step_graph` a step's carry is a `TrainState` whose tensors
are static buffers: the step still returns fresh tensors, and the graph
copies them back into the buffers at the end of the captured region
(one `_foreach_copy_`). `step` is a host int that the trainers advance
outside the graph, K per dispatch; Adam's `count` is a device tensor
and advances inside it.

The preprocessor (`preprocessor_cls`, the no-op one by default) runs
where the JAX package runs it: first thing in the train and eval steps'
forward and in `predict_step`, over the batch already on the device.
Input generators read its in-specs (`set_specification_from_model`).
The JAX model draws a dummy init batch from the preprocessor's
out-specs for `flax.init`; the port builds its networks from their
constructor arguments and needs none.

Stochastic layers (dropout, `layers.core`) and a preprocessor's random
crops and distortions draw from the model's explicit generator
(`generator(device)`) in TRAIN mode only; the trainer seeds it and, on
the card, registers it with each captured step's graph, so every replay
draws fresh numbers.

`remat_policy` ("none", "full", "dots", "dots_no_batch"; JAX's
`jax.checkpoint` policies) recomputes the loss's forward in the backward
(`torch.utils.checkpoint` around `loss_fn`, with a selective policy that
saves what the JAX policy saves: nothing for "full", every matmul for
"dots", the matmuls without batch dims for "dots_no_batch"). Every
policy also saves the random draws, so the recomputed forward sees the
same dropout masks and the gradients equal "none"'s bit for bit.

Not ported yet: `axis_name` (ROADMAP A11). It raises where it is asked
for.
"""

from __future__ import annotations

import abc
import copy

import dataclasses
import functools
import math
import weakref
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.device import DeviceLike, resolve_device
from tensor2robot_tpu_torch.layers import core
from tensor2robot_tpu_torch.layers.vision_layers import collect_batch_stats
from tensor2robot_tpu_torch.models import optimizers as opt_lib
from tensor2robot_tpu_torch.models.model_interface import ModelInterface
from tensor2robot_tpu_torch.preprocessors.noop_preprocessor import (
    NoOpPreprocessor,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct

Metrics = Dict[str, torch.Tensor]

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_MATMULS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
# What each policy saves besides the random draws (JAX's
# `checkpoint_policies`: "full" none, "dots" every dot, "dots_no_batch" the
# dots without batch dims).
REMAT_POLICIES = {"full": (), "dots": _MATMULS + _BATCHED_MATMULS,
                  "dots_no_batch": _MATMULS}


def _remat_policy(saved, ctx, op, *args, **kwargs):
  """Selective checkpointing's policy: save `saved` ops' outputs and every
  seeded random draw (recomputing a draw would redraw it), recompute the
  rest."""
  del ctx, args, kwargs
  policy = torch.utils.checkpoint.CheckpointPolicy
  if op in saved or torch.Tag.nondeterministic_seeded in getattr(
      op, "tags", ()):
    return policy.MUST_SAVE
  return policy.PREFER_RECOMPUTE


@dataclasses.dataclass(frozen=True, eq=False)
class TrainState:
  """Carried state: step counter, params and batch statistics.

  `params` and `batch_stats` are flat dicts keyed by the network's
  parameter and buffer names (torch `state_dict` keys, e.g.
  ``q_head.dense_0.weight`` or ``torso_bn_0.mean``). Master params are
  float32, as flax params are.
  """

  step: int
  params: Dict[str, torch.Tensor]
  batch_stats: Dict[str, torch.Tensor]
  opt_state: Any = None

  @property
  def variables(self) -> Dict[str, torch.Tensor]:
    return {**self.params, **self.batch_stats}

  @property
  def nbytes(self) -> int:
    return sum(t.numel() * t.element_size()
               for t in self.variables.values())

  def to(self, device) -> "TrainState":
    """Params and batch stats on `device` (the optimizer state stays)."""
    move = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    return dataclasses.replace(self, params=move(self.params),
                               batch_stats=move(self.batch_stats))

  @classmethod
  def from_network(cls, network: nn.Module, step: int = 0) -> "TrainState":
    return cls(step=step,
               params={k: v.detach()
                       for k, v in network.named_parameters()},
               batch_stats={k: v.detach()
                            for k, v in network.named_buffers()})


def init_parameters(network: nn.Module, generator: torch.Generator) -> None:
  """flax's default init, drawn from `generator`: lecun-normal
  (truncated normal, fan-in) conv (1D and 2D) and dense kernels, zero
  biases.
  A module with raw params of its own (learned positions, a pipelined
  trunk's stacked stages, whose modules are marked `stage_stacked`)
  draws them in its `init_raw_parameters(generator)`."""
  for module in network.modules():
    if hasattr(module, "init_raw_parameters"):
      module.init_raw_parameters(generator)
    if getattr(module, "stage_stacked", False):
      continue  # a pipelined trunk's stacked stages: drawn by the trunk
    if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
      fan_in = module.weight[0].numel()
      # 0.8796 = std of a unit normal truncated to [-2, 2].
      std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
      with torch.no_grad():
        nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if module.bias is not None:
          module.bias.zero_()


def _flat(struct) -> Dict[str, Any]:
  """A TensorSpecStruct or mapping as a flat '/'-keyed dict."""
  return (struct.to_flat_dict() if hasattr(struct, "to_flat_dict")
          else dict(struct))


class AbstractT2RModel(ModelInterface):
  """Base class for models: specs + network construction + loss.

  Subclasses implement `get_feature_specification(mode)`,
  `get_label_specification(mode)`, `create_network()` and, to train,
  `model_train_fn(features, labels, outputs, mode) -> (loss, scalars)`;
  optionally `model_eval_fn(features, labels, outputs) -> scalars`
  (default: the train fn's loss and scalars).
  """

  AUX_LOSS_OUTPUT = "_aux_loss"
  # True where `predict_step` takes `torch.func` transforms, which
  # `torch.export` cannot trace: the exporter records such a step with
  # `make_fx` first (`export/savedmodel_export_generator.py`).
  predict_step_has_function_transforms = False

  def __init__(self, device_dtype: torch.dtype = torch.float32,
               create_optimizer_fn: Callable[
                   [], opt_lib.GradientTransformation] = (
                       opt_lib.create_optimizer),
               aux_loss_weight: float = 0.01,
               remat_policy: Optional[str] = None,
               preprocessor_cls: Optional[Callable] = None,
               init_from_checkpoint_path: Optional[str] = None):
    """`preprocessor_cls` is called with the model's two spec getters;
    None means `NoOpPreprocessor`. `init_from_checkpoint_path` warm-starts
    every new state from a checkpoint of the port's (a model_dir, a step
    directory or a state file): params present there override the fresh
    initializers, batch statistics ride along
    (`maybe_init_from_checkpoint`)."""
    if remat_policy not in (None, "none") and (
        remat_policy not in REMAT_POLICIES):
      raise ValueError(
          f"remat_policy={remat_policy!r} not in "
          f"{['none'] + sorted(REMAT_POLICIES)}")
    self._remat_policy = (None if remat_policy in (None, "none")
                          else remat_policy)
    self._generators: Dict[str, torch.Generator] = {}
    self._device_dtype = device_dtype
    self._aux_loss_weight = aux_loss_weight
    self._create_optimizer_fn = create_optimizer_fn
    self._preprocessor_cls = preprocessor_cls
    self._init_from_checkpoint_path = init_from_checkpoint_path
    self._preprocessor = None
    self._tx: Optional[opt_lib.GradientTransformation] = None
    self._train_network: Optional[nn.Module] = None
    self._bound: "weakref.WeakKeyDictionary[TrainState, nn.Module]" = (
        weakref.WeakKeyDictionary())
    self._mesh = None

  @abc.abstractmethod
  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    ...

  @abc.abstractmethod
  def get_label_specification(
      self, mode: Mode) -> Optional[TensorSpecStruct]:
    ...

  @property
  def device_dtype(self) -> torch.dtype:
    """Compute dtype the network casts to in its forward pass."""
    return self._device_dtype

  @property
  def mesh(self):
    """The mesh (`parallel.mesh`) the model's steps reduce over; None
    on one device."""
    return self._mesh

  def without_mesh(self) -> "AbstractT2RModel":
    """The same model on one device: a copy without the mesh, its
    networks built anew at their first use (a pipelined trunk then holds
    every stage, and no step runs a collective). A model without a mesh
    is its own."""
    if self._mesh is None:
      return self
    twin = copy.copy(self)
    twin._mesh = None
    twin._train_network = None
    twin._bound = weakref.WeakKeyDictionary()
    twin._generators = {}
    return twin

  def generator(self, device: DeviceLike) -> torch.Generator:
    """The model's explicit generator on `device` (made once, seeded 0;
    a trainer reseeds it): dropout masks and the preprocessor's random
    draws in TRAIN mode come from it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
      # "cuda" and "cuda:0" name one generator (a trainer's device and
      # its parameters' device).
      device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    if key not in self._generators:
      self._generators[key] = torch.Generator(device=device).manual_seed(0)
    return self._generators[key]

  @property
  def draws_random(self) -> bool:
    """Whether a TRAIN step draws random numbers: a dropout layer with a
    rate above 0, or a preprocessor that draws (`draws_random`)."""
    if getattr(self.preprocessor, "draws_random", False):
      return True
    if self._train_network is None:
      with torch.device("meta"):
        self._train_network = self.create_network()
    return any(getattr(m, "dropout_rate", 0.0) > 0
               for m in self._train_network.modules())

  @property
  def preprocessor(self):
    """The preprocessor, made once from `preprocessor_cls`."""
    if self._preprocessor is None:
      cls = self._preprocessor_cls or NoOpPreprocessor
      self._preprocessor = cls(self.get_feature_specification,
                               self.get_label_specification)
    return self._preprocessor

  @abc.abstractmethod
  def create_network(self) -> nn.Module:
    ...

  def create_inference_state(self, seed: int = 0,
                             device: DeviceLike = None) -> TrainState:
    """Fresh params + batch stats from `seed` (no optimizer state), on
    `device` (None = the CUDA card; raises without one); warm-started
    when `init_from_checkpoint_path` is set."""
    device = resolve_device(device)
    network = self.create_network()
    init_parameters(network, torch.Generator().manual_seed(seed))
    state = TrainState.from_network(network).to(device)
    if self._init_from_checkpoint_path:
      params, batch_stats = self.maybe_init_from_checkpoint(
          state.params, state.batch_stats)
      state = dataclasses.replace(state, params=params,
                                  batch_stats=batch_stats)
    return state

  def maybe_init_from_checkpoint(self, params, batch_stats=None):
    """Warm-starts params (and BN statistics) from
    `init_from_checkpoint_path`: (params, batch_stats), each leaf on its
    `params` / `batch_stats` leaf's device and dtype.

    BN moving averages ride along when the model carries batch statistics:
    trained weights with fresh-init statistics would silently degrade the
    model. Reads the port's checkpoints (`utils/checkpoints.py`), not
    orbax's."""
    from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
    if batch_stats:
      variables = ckpt_lib.restore_variables(
          self._init_from_checkpoint_path,
          like={"params": params, "batch_stats": batch_stats})
      return variables["params"], variables["batch_stats"]
    restored = ckpt_lib.restore_params(
        self._init_from_checkpoint_path, like=params)
    return restored, batch_stats

  @property
  def tx(self) -> opt_lib.GradientTransformation:
    """The optimizer, made once by `create_optimizer_fn()`."""
    if self._tx is None:
      self._tx = self._create_optimizer_fn()
    return self._tx

  def create_train_state(self, seed: int = 0,
                         device: DeviceLike = None) -> TrainState:
    """`create_inference_state` plus the optimizer's state."""
    state = self.create_inference_state(seed=seed, device=device)
    return dataclasses.replace(state, opt_state=self.tx.init(state.params))

  # ---- training (the JAX package's pure steps, eagerly) ----

  def model_train_fn(self, features: Mapping[str, torch.Tensor],
                     labels: Optional[Mapping[str, torch.Tensor]],
                     outputs: Any, mode: Mode
                     ) -> Tuple[torch.Tensor, Metrics]:
    """Returns (scalar loss, scalar metrics dict)."""
    raise NotImplementedError(f"{type(self).__name__} has no training loss")

  def network_inputs_from_labels(self, features, labels, mode: Mode):
    """Hook: lift label-derived conditioning inputs into the features
    (train/eval only). Default: unchanged."""
    del labels, mode
    return features

  def model_eval_fn(self, features, labels, outputs) -> Metrics:
    """Eval scalars: the train fn's loss (as `loss`) and scalars."""
    loss, scalars = self.model_train_fn(features, labels, outputs,
                                        Mode.EVAL)
    return {"loss": loss, **scalars}

  def _apply_network(self, params, batch_stats, features, labels,
                     mode: Mode):
    """(features as the network saw them, the preprocessed labels,
    outputs without the aux loss, the aux loss or None, new batch stats)
    over `params`."""
    if self._train_network is None:
      with torch.device("meta"):
        self._train_network = self.create_network()
    train = mode == Mode.TRAIN
    self._train_network.train(train)
    generator = None
    if train and self.draws_random:
      generator = self.generator(next(iter(params.values())).device)
    features, labels = self.preprocessor.preprocess(
        _flat(features), _flat(labels), mode, generator)
    features = self.network_inputs_from_labels(features, labels, mode)
    with core.random_stream(generator):
      outputs = torch.func.functional_call(
          self._train_network, {**params, **batch_stats}, (features,),
          strict=True)
    new_stats = collect_batch_stats(self._train_network)
    # Popped before the model's fns: they never see the private key.
    aux = (outputs.pop(self.AUX_LOSS_OUTPUT, None)
           if isinstance(outputs, dict) else None)
    return (features, labels, outputs, aux,
            new_stats if train and batch_stats else batch_stats)

  def _with_aux(self, metrics: Metrics, aux, what: str) -> Metrics:
    if "aux_loss" in metrics:
      raise ValueError(
          f"{what} reported a scalar named 'aux_loss'; that key is "
          "reserved for the network's auxiliary loss "
          f"({self.AUX_LOSS_OUTPUT}) — rename the subclass scalar.")
    return {**metrics, "aux_loss": aux}

  def loss_fn(self, params: Dict[str, torch.Tensor],
              batch_stats: Dict[str, torch.Tensor], features, labels,
              mode: Mode) -> Tuple[torch.Tensor, Tuple[Metrics, Dict]]:
    """(loss, (scalars, new_batch_stats)) of the network over `params`
    and `batch_stats`. In TRAIN mode batch norm normalizes with the
    batch's statistics and the new running statistics are returned;
    otherwise `batch_stats` come back as they were. Neither is written
    in place. A network's auxiliary loss adds `aux_loss_weight` times
    itself to the loss."""
    features, labels, outputs, aux, new_stats = self._apply_network(
        params, batch_stats, features, labels, mode)
    loss, scalars = self.model_train_fn(features, labels, outputs, mode)
    if aux is not None:
      loss = loss + self._aux_loss_weight * aux
      scalars = self._with_aux(scalars, aux, "model_train_fn")
    return loss, (scalars, new_stats)

  def _loss_for_grad(self) -> Callable:
    """`loss_fn`, under `torch.utils.checkpoint` per `remat_policy` (the
    module docstring)."""
    if self._remat_policy is None:
      return self.loss_fn
    context_fn = functools.partial(
        torch.utils.checkpoint.create_selective_checkpoint_contexts,
        functools.partial(_remat_policy, REMAT_POLICIES[self._remat_policy]))

    def loss(*args):
      return torch.utils.checkpoint.checkpoint(
          self.loss_fn, *args, use_reentrant=False, context_fn=context_fn)

    return loss

  def eval_step(self, state: TrainState, features, labels) -> Metrics:
    """Eval metrics of `state` on a batch (`model_eval_fn`), the network
    in eval mode, without autograd. With an auxiliary loss: `aux_loss`
    reported and, where a `loss` is, weighted into it."""
    with torch.no_grad():
      features, labels, outputs, aux, _ = self._apply_network(
          state.params, state.batch_stats, features, labels, Mode.EVAL)
      metrics = self.model_eval_fn(features, labels, outputs)
      if aux is not None:
        metrics = self._with_aux(metrics, aux, "model_eval_fn")
        if "loss" in metrics:
          metrics["loss"] = metrics["loss"] + self._aux_loss_weight * aux
    return {k: v.detach() for k, v in metrics.items()}

  def train_grads(self, state: TrainState, features, labels,
                  axis_name: Optional[str] = None
                  ) -> Tuple[Dict[str, torch.Tensor], Dict, Metrics]:
    """The forward/backward half of `train_step`: (grads, new batch
    stats, metrics). Metrics are `loss`, `grad_norm` (optax's
    `global_norm` of the grads) and the model's scalars, detached."""
    if axis_name is not None:
      raise NotImplementedError(
          f"axis_name={axis_name!r}: data-parallel steps are not ported "
          "yet (ROADMAP A11).")
    params = {k: v.detach().requires_grad_() for k, v in
              state.params.items()}
    with torch.enable_grad():
      loss, (scalars, new_stats) = self._loss_for_grad()(
          params, state.batch_stats, features, labels, Mode.TRAIN)
      leaves = list(params.values())
      # A parameter the loss does not reach gets a zero gradient, as
      # under jax.grad.
      grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    metrics = {"loss": loss.detach(),
               "grad_norm": opt_lib.global_norm(grads),
               **{k: v.detach() for k, v in scalars.items()}}
    return grads, new_stats, metrics

  def apply_gradients(self, state: TrainState, grads: Dict[str, torch.Tensor],
                      new_stats: Dict[str, torch.Tensor]) -> TrainState:
    """The optimizer half of `train_step`: tx.update, then p + u."""
    updates, opt_state = self.tx.update(grads, state.opt_state,
                                        state.params)
    return TrainState(step=state.step + 1,
                      params=opt_lib.apply_updates(state.params, updates),
                      batch_stats=new_stats, opt_state=opt_state)

  def train_step(self, state: TrainState, features, labels,
                 axis_name: Optional[str] = None
                 ) -> Tuple[TrainState, Metrics]:
    """One optimizer step on a batch: (new state, metrics). Where JAX
    takes an rng, the port draws from the model's `generator`."""
    grads, new_stats, metrics = self.train_grads(state, features, labels,
                                                 axis_name=axis_name)
    return self.apply_gradients(state, grads, new_stats), metrics

  def predict_step(self, state: TrainState, features) -> Any:
    """The bound network's outputs on the preprocessed `features`,
    without autograd and without the auxiliary loss."""
    with torch.inference_mode():
      features, _ = self.preprocessor.preprocess(features, None,
                                                 Mode.PREDICT)
      outputs = self.bind(state)(features)
    if isinstance(outputs, dict):
      outputs.pop(self.AUX_LOSS_OUTPUT, None)
    return outputs

  def bind(self, state: TrainState) -> nn.Module:
    """The network in eval mode over `state`'s own tensors.

    Built on the meta device and assigned the state's tensors, so no
    parameter is copied or initialized; cached per state object (a
    swapped-in state gets its own module, the old one stays intact for
    dispatches still running on it).
    """
    network = self._bound.get(state)
    if network is None:
      with torch.device("meta"):
        network = self.create_network()
      network.load_state_dict(state.variables, strict=True, assign=True)
      network.eval()
      self._bound[state] = network
    return network
