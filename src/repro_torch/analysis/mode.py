"""Analysis mode: make the cost count of an ISGD step an upper bound.

Port of ``repro.analysis.mode``. Under ``analysis_mode()`` the device form
of the ISGD step (``core.isgd.isgd_step_device``) takes the accelerate
branch and runs exactly ``stop`` Alg. 2 trips, the paper's early-stopping
upper bound, as the reference's convergence-masked loop does: every
``run_if`` body runs, and the trip's writes are masked by its ``live``
flag, so the step's numbers stay those of the normal step. That is also
what lets the step run on the meta device at all: a meta tensor has no
value, so no branch can be taken on one. The collectives of
``core.reduce`` record their bytes in analysis mode (``analysis.count``).

The reference's ``scan_unroll`` has no counterpart: eager PyTorch has no
rolled scan whose body a cost analysis would count once. Every loop the
port runs (attention and loss chunks, the SSD chunk recurrence, the
layers) executes, and is counted, trip by trip.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def in_analysis_mode() -> bool:
    return getattr(_state, "on", False)


@contextlib.contextmanager
def analysis_mode(on: bool = True):
    prev = in_analysis_mode()
    _state.on = on
    try:
        yield
    finally:
        _state.on = prev
