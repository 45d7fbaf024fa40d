"""MAML: model-agnostic meta-learning over any base T2R model (port of
`meta_learning/maml_model.py`).

The meta batch nests the base model's specs under two splits:

  features.condition/<base feature keys>  [B_tasks, N_cond, ...]
  features.inference/<base feature keys>  [B_tasks, N_inf, ...]
  labels.condition/<base label keys>      [B_tasks, N_cond, ...]
  labels.inference/<base label keys>      [B_tasks, N_inf, ...]

Per task, K inner SGD steps on the condition set adapt the base
network's params, and the outer loss is the adapted network's loss on
the inference set. The JAX package scans `jax.grad` over the K steps and
vmaps over tasks; here each inner step is `torch.func.grad` over
`torch.func.functional_call` of the base network (on the meta device),
and the tasks run in a loop (equal results; the whole step captures in
one CUDA graph, so the loop costs no host time on the card). The inner
gradients are second order unless `first_order`, where `.detach()`
stands for `lax.stop_gradient`. A learned inner rate is
`exp(params["inner_lr_log"])`.

The state's params are the base network's under ``base_net.`` plus
``inner_lr_log`` when it is learned, the flax `_MetaNetwork`'s nesting.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    TrainState,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct

CONDITION = "condition"
INFERENCE = "inference"
CONDITION_LABELS = "condition_labels"

_BASE = "base_net."
INNER_LR_LOG = "inner_lr_log"


def _flat(struct) -> Dict[str, Any]:
  if struct is None:
    return {}
  return (struct.to_flat_dict() if hasattr(struct, "to_flat_dict")
          else dict(struct))


def _nest_spec(base_spec: Optional[TensorSpecStruct],
               splits: Tuple[Tuple[str, int], ...],
               optional: bool = False) -> Optional[TensorSpecStruct]:
  """Wraps a base spec under per-split prefixes with per-task sample dims.

  Wire names are prefixed too: condition/x and inference/x must be
  distinct tf.Example keys. A jpeg/png wire encoding holds one image, so
  the nested (N, H, W, C) sample set travels as raw numeric data.
  """
  if base_spec is None:
    return None
  flat = _flat(base_spec)
  out = {}
  for split, n in splits:
    for key, spec in flat.items():
      nested = spec.replace(shape=(n,) + tuple(spec.shape),
                            name=f"{split}_{spec.name or key}")
      if nested.data_format is not None:
        nested = nested.replace(data_format=None)
      if optional:
        nested = nested.replace(is_optional=True)
      out[f"{split}/{key}"] = nested
  return TensorSpecStruct.from_flat_dict(out)


def _split(struct, split: str) -> Dict[str, Any]:
  """The `split/` substructure of a flat dict or struct, as a flat dict
  without the prefix."""
  prefix = split + "/"
  return {k[len(prefix):]: v for k, v in _flat(struct).items()
          if k.startswith(prefix)}


def _with_demos(spec: TensorSpecStruct, label_spec, num_condition: int
                ) -> TensorSpecStruct:
  """`spec` plus the optional predict-time demonstration labels under
  ``condition_labels/``."""
  demo = _nest_spec(label_spec, ((CONDITION_LABELS, num_condition),),
                    optional=True)
  if demo is None:
    return spec
  flat = spec.to_flat_dict()
  flat.update(demo.to_flat_dict())
  return TensorSpecStruct.from_flat_dict(flat)


class MAMLPreprocessor:
  """Runs the base model's preprocessor on each meta split: per split
  the task dim folds into the batch dim, the base preprocess runs, and
  the result unfolds back. Predict-time demonstration labels (under
  ``condition_labels/``) ride the base label path too."""

  def __init__(self, base_preprocessor, num_condition: int,
               num_inference: int):
    self._base = base_preprocessor
    self._num_condition = num_condition
    self._num_inference = num_inference

  def _splits(self):
    return ((CONDITION, self._num_condition),
            (INFERENCE, self._num_inference))

  def get_in_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    spec = _nest_spec(self._base.get_in_feature_specification(mode),
                      self._splits())
    if mode == Mode.PREDICT:
      spec = _with_demos(spec, self._base.get_in_label_specification(mode),
                         self._num_condition)
    return spec

  def get_in_label_specification(self, mode: Mode):
    return _nest_spec(self._base.get_in_label_specification(mode),
                      self._splits())

  def get_out_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    spec = _nest_spec(self._base.get_out_feature_specification(mode),
                      self._splits())
    if mode == Mode.PREDICT:
      spec = _with_demos(spec,
                         self._base.get_out_label_specification(mode),
                         self._num_condition)
    return spec

  def get_out_label_specification(self, mode: Mode):
    return _nest_spec(self._base.get_out_label_specification(mode),
                      self._splits())

  def preprocess(self, features, labels, mode: Mode,
                 generator: Optional[torch.Generator] = None):
    """Flat (features, labels) dicts → preprocessed flat dicts (labels
    None when none came)."""
    out_f, out_l = {}, {}
    flat_features = _flat(features)
    has_labels = bool(_flat(labels))
    demo_prefix = CONDITION_LABELS + "/"
    demo_keys = [k for k in flat_features if k.startswith(demo_prefix)]
    for split, n in self._splits():
      f = _split(flat_features, split)
      l = _split(labels, split) if has_labels else None
      demo_as_labels = split == CONDITION and demo_keys and l is None
      if demo_as_labels:
        l = {k[len(demo_prefix):]: flat_features[k] for k in demo_keys}
      num_tasks = next(iter(f.values())).shape[0]

      def fold(x, n=n, num_tasks=num_tasks):
        return x.reshape((num_tasks * n,) + tuple(x.shape[2:]))

      def unfold(x, n=n, num_tasks=num_tasks):
        return x.reshape((num_tasks, n) + tuple(x.shape[1:]))

      f2, l2 = self._base.preprocess(
          {k: fold(v) for k, v in f.items()},
          {k: fold(v) for k, v in l.items()} if l is not None else None,
          mode, generator)
      for key, value in _flat(f2).items():
        out_f[f"{split}/{key}"] = unfold(value)
      if l2 is not None:
        prefix = f"{CONDITION_LABELS}/" if demo_as_labels else f"{split}/"
        target = out_f if demo_as_labels else out_l
        for key, value in _flat(l2).items():
          target[prefix + key] = unfold(value)
    # Demonstrations supplied alongside labels pass through unchanged.
    for key, value in flat_features.items():
      if key.startswith(demo_prefix) and key not in out_f:
        out_f[key] = value
    return out_f, (out_l if out_l else (_flat(labels) if has_labels
                                        else None))


class _MetaNetwork(nn.Module):
  """The base network under ``base_net`` and, when learned, the scalar
  ``inner_lr_log``. Its forward (the flax init path) runs the base
  network on the condition split folded into one batch."""

  def __init__(self, base_net: nn.Module, learn_inner_lr: bool,
               init_inner_lr: float):
    super().__init__()
    self.base_net = base_net
    self.init_inner_lr = init_inner_lr
    if learn_inner_lr:
      self.inner_lr_log = nn.Parameter(
          torch.tensor(math.log(init_inner_lr), dtype=torch.float32))

  def init_raw_parameters(self, generator: torch.Generator) -> None:
    del generator
    if hasattr(self, INNER_LR_LOG):
      with torch.no_grad():
        self.inner_lr_log.fill_(math.log(self.init_inner_lr))

  def forward(self, features):
    cond = _split(features, CONDITION)
    return self.base_net({k: v.reshape((-1,) + tuple(v.shape[2:]))
                          for k, v in cond.items()})


@gin.configurable
class MAMLModel(AbstractT2RModel):
  """Meta-trains `base_model` with inner-loop adaptation.

  Works with any base model whose network carries no batch statistics
  (per-task adapted statistics are ill-defined): `loss_fn` refuses a
  state that has them. Its `predict_step` adapts with `torch.func.grad`,
  which the exporter records with `make_fx` at a fixed task batch.
  """

  predict_step_has_function_transforms = True

  def __init__(self,
               base_model: AbstractT2RModel,
               num_inner_steps: int = 1,
               inner_lr: float = 0.01,
               first_order: bool = False,
               learn_inner_lr: bool = False,
               num_condition_samples_per_task: int = 4,
               num_inference_samples_per_task: int = 4,
               report_pre_adaptation_loss: bool = False,
               **kwargs):
    kwargs.setdefault("device_dtype", base_model.device_dtype)
    super().__init__(**kwargs)
    self._base = base_model
    self._num_inner_steps = num_inner_steps
    self._inner_lr = inner_lr
    self._first_order = first_order
    self._learn_inner_lr = learn_inner_lr
    self._num_condition = num_condition_samples_per_task
    self._num_inference = num_inference_samples_per_task
    self._report_pre_adaptation_loss = report_pre_adaptation_loss
    self._base_network: Optional[nn.Module] = None

  @property
  def base_model(self) -> AbstractT2RModel:
    return self._base

  @property
  def preprocessor(self):
    """The base model's preprocessor, lifted over the meta splits."""
    if self._preprocessor is None:
      self._preprocessor = MAMLPreprocessor(
          self._base.preprocessor, self._num_condition, self._num_inference)
    return self._preprocessor

  # ---- specs: base specs nested under condition/inference ----

  def _splits(self):
    return ((CONDITION, self._num_condition),
            (INFERENCE, self._num_inference))

  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    spec = _nest_spec(self._base.get_feature_specification(mode),
                      self._splits())
    if mode == Mode.PREDICT:
      # Serving carries demonstration labels inside the feature struct
      # (optional: absent means zero-shot).
      spec = _with_demos(spec, self._base.get_label_specification(mode),
                         self._num_condition)
    return spec

  def get_label_specification(self, mode: Mode):
    return _nest_spec(self._base.get_label_specification(mode),
                      self._splits())

  # ---- network ----

  def create_network(self) -> nn.Module:
    return _MetaNetwork(self._base.create_network(), self._learn_inner_lr,
                        self._inner_lr)

  def model_train_fn(self, features, labels, outputs, mode):
    """Unused: MAML computes its loss in `loss_fn`."""
    raise NotImplementedError(
        "MAMLModel computes its loss in loss_fn; model_train_fn is the "
        "base model's.")

  # ---- the meta loss ----

  def _base_net(self, mode: Mode) -> nn.Module:
    if self._base_network is None:
      with torch.device("meta"):
        self._base_network = self._base.create_network()
    self._base_network.train(mode == Mode.TRAIN)
    return self._base_network

  def _task_loss(self, base_params, features, labels, mode: Mode):
    """(loss, scalars) of the base model on one task's [N, ...] set."""
    outputs = torch.func.functional_call(self._base_net(mode), base_params,
                                         (features,), strict=True)
    return self._base.model_train_fn(features, labels, outputs, mode)

  def _inner_lr_of(self, params) -> Any:
    if self._learn_inner_lr:
      return torch.exp(params[INNER_LR_LOG])
    return self._inner_lr

  def _adapt(self, base_params, inner_lr, cond_f, cond_l, mode: Mode):
    """K inner SGD steps on the condition set."""

    def inner_loss(params):
      return self._task_loss(params, cond_f, cond_l, mode)[0]

    params = base_params
    for _ in range(self._num_inner_steps):
      grads = torch.func.grad(inner_loss)(params)
      if self._first_order:
        grads = {k: g.detach() for k, g in grads.items()}
      params = {k: p - inner_lr * grads[k].to(p.dtype)
                for k, p in params.items()}
    return params

  def loss_fn(self, params: Dict[str, torch.Tensor],
              batch_stats: Dict[str, torch.Tensor], features, labels,
              mode: Mode):
    if batch_stats:
      raise ValueError(
          "MAMLModel requires a batch-stats-free base network "
          "(use GroupNorm/LayerNorm instead of BatchNorm).")
    train = mode == Mode.TRAIN
    features, labels = self.preprocessor.preprocess(features, labels, mode)
    base_params = {k[len(_BASE):]: v for k, v in params.items()
                   if k.startswith(_BASE)}
    inner_lr = self._inner_lr_of(params)
    cond_f, inf_f = _split(features, CONDITION), _split(features, INFERENCE)
    cond_l, inf_l = _split(labels, CONDITION), _split(labels, INFERENCE)
    num_tasks = next(iter(cond_f.values())).shape[0]
    # The pre-adaptation diagnostic costs a third forward pass per task:
    # only in eval or when asked for.
    report_pre = self._report_pre_adaptation_loss or not train
    outer_losses, pre_losses, scalars = [], [], []
    for i in range(num_tasks):
      task = lambda d, i=i: {k: v[i] for k, v in d.items()}  # noqa: E731
      adapted = self._adapt(base_params, inner_lr, task(cond_f),
                            task(cond_l), mode)
      outer_loss, outer_scalars = self._task_loss(adapted, task(inf_f),
                                                  task(inf_l), mode)
      outer_losses.append(outer_loss)
      scalars.append(outer_scalars)
      if report_pre:
        with torch.no_grad():
          pre_losses.append(self._task_loss(base_params, task(inf_f),
                                            task(inf_l), Mode.EVAL)[0])
    loss = torch.stack(outer_losses).mean()
    metrics = {k: torch.stack([s[k] for s in scalars]).mean()
               for k in scalars[0]}
    if report_pre:
      metrics["pre_adaptation_loss"] = torch.stack(pre_losses).mean()
    metrics["post_adaptation_loss"] = loss
    return loss, (metrics, batch_stats)

  def eval_step(self, state: TrainState, features, labels):
    """Eval = the meta loss without outer gradients (the inner loop still
    differentiates: `torch.func.grad` ignores the outer `no_grad`)."""
    with torch.no_grad():
      loss, (metrics, _) = self.loss_fn(state.params, state.batch_stats,
                                        features, labels, Mode.EVAL)
    return {k: v.detach() for k, v in {"loss": loss, **metrics}.items()}

  # ---- serving: adapt on condition, answer on inference ----

  def predict_step(self, state: TrainState, features) -> Any:
    """Per task: adapt on the demonstrations under ``condition_labels/``
    when they came (else zero-shot), then the base network on the
    inference split; outputs stacked over tasks."""
    features, _ = self.preprocessor.preprocess(features, None,
                                               Mode.PREDICT)
    base_params = {k[len(_BASE):]: v for k, v in state.params.items()
                   if k.startswith(_BASE)}
    cond_f, inf_f = _split(features, CONDITION), _split(features, INFERENCE)
    cond_l = _split(features, CONDITION_LABELS) or None
    num_tasks = next(iter(cond_f.values())).shape[0]
    outputs = []
    with torch.no_grad():
      inner_lr = self._inner_lr_of(state.params)
      for i in range(num_tasks):
        task = lambda d, i=i: {k: v[i] for k, v in d.items()}  # noqa: E731
        params = base_params
        if cond_l is not None:
          params = self._adapt(base_params, inner_lr, task(cond_f),
                               task(cond_l), Mode.PREDICT)
        outputs.append(torch.func.functional_call(
            self._base_net(Mode.PREDICT), params, (task(inf_f),),
            strict=True))
    return {k: torch.stack([o[k] for o in outputs]) for k in outputs[0]}
