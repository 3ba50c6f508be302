"""Telemetry: structured metrics, the live SPC control chart, timing and
profiler spans.

Port of ``repro.obs``, with the same ``__all__``. See README.md in this
package for the record schema and the host-boundary rule.
"""
from repro_torch.obs.console import CONSOLE, Console
from repro_torch.obs.observer import TrainObserver
from repro_torch.obs.recorder import (ConsoleSink, JsonlSink, MemorySink,
                                      MetricsRecorder, jsonl_path, read_jsonl,
                                      validate_record, write_merged_summary)
from repro_torch.obs.spc import SPCExporter
from repro_torch.obs.stats import percentile, summarize
from repro_torch.obs.timing import (EstimatedWallError, StepTimer, annotate,
                                    maybe_profile, named_scope,
                                    require_measured_walls)

__all__ = [
    "CONSOLE", "Console", "ConsoleSink", "EstimatedWallError", "JsonlSink",
    "MemorySink", "MetricsRecorder", "SPCExporter", "StepTimer",
    "TrainObserver", "annotate", "jsonl_path", "maybe_profile",
    "named_scope", "percentile", "read_jsonl", "require_measured_walls",
    "summarize", "validate_record", "write_merged_summary",
]
