"""Regression model base (port of `models/regression_model.py`).

This slice ports the output convention only: the key under which a
network's serving output goes. `RegressionModel` itself comes with the
families that use it (ROADMAP A10).
"""

INFERENCE_OUTPUT = "inference_output"
