"""Utilities: checkpointing, config, profiling, debugging, metrics (PyTorch).

Counterpart of ``beer_tpu/utils``.  Of its profiling hooks the port keeps
:func:`named_scope`, the span of :mod:`beer_tpu_torch.utils.profiling`;
a trace is any ``torch.profiler.profile`` around the program.
"""

from beer_tpu_torch.utils.checkpoint import latest_checkpoint, load_model, save_model
from beer_tpu_torch.utils.config import load_yaml
from beer_tpu_torch.utils.debug import assert_finite, guard_finite_outputs, nan_guard
from beer_tpu_torch.utils.metrics import MetricsLogger
from beer_tpu_torch.utils.profiling import named_scope

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
]
