"""Train/eval/predict modes (the `Mode` enum of the JAX package's
`data/abstract_input_generator.py`; the generators come with the
training slice)."""

from __future__ import annotations

import enum


class Mode(str, enum.Enum):
  """Train/eval/predict modes (reference: tf.estimator.ModeKeys)."""

  TRAIN = "train"
  EVAL = "eval"
  PREDICT = "predict"
