"""Utilities: checkpointing, config, profiling, debugging, metrics (PyTorch).

Counterpart of ``beer_tpu/utils`` with the same exports.
"""

from beer_tpu_torch.utils.checkpoint import latest_checkpoint, load_model, save_model
from beer_tpu_torch.utils.config import load_yaml
from beer_tpu_torch.utils.debug import assert_finite, guard_finite_outputs, nan_guard
from beer_tpu_torch.utils.metrics import MetricsLogger
from beer_tpu_torch.utils.profiling import SpanTimer, named_scope, trace

__all__ = [
    "save_model",
    "load_model",
    "latest_checkpoint",
    "load_yaml",
    "guard_finite_outputs",
    "nan_guard",
    "assert_finite",
    "MetricsLogger",
    "named_scope",
    "trace",
    "SpanTimer",
]
