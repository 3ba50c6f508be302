"""Deterministic fault injection (``FaultPlan``) for the async-PS engine.

Port of ``repro.fault``. See ``repro_torch.fault.plan`` for the event model
and ``repro_torch.distributed.async_ps`` for where the hooks land. Exports
resolve lazily, as in the reference.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "FaultEvent": "repro_torch.fault.plan",
    "FaultPlan": "repro_torch.fault.plan",
    "NO_FAULTS": "repro_torch.fault.plan",
    "InjectedCrash": "repro_torch.fault.plan",
    "TransientPushError": "repro_torch.fault.plan",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(_EXPORTS)
