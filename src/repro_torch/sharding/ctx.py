"""Activation-sharding context.

Port of ``repro.sharding.ctx``. Model code calls ``constrain(x, kind)`` at
the reference's points ("hidden" after the embedding and after each layer,
"logits" after the head, "decode_hidden" in a decode step). Outside a
context it is the identity, so models stay mesh-agnostic; the launcher
installs a rule table (kind -> spec, ``rules.make_constrain``) for the
hybrid engine's mesh. The function installed is a thread's own, as in the
reference.

The port adds the tensor-parallel context beside it: ``tensor_parallel(tp)``
makes ``tp`` (the hybrid engine's model-axis collectives,
``repro_torch.distributed.data_parallel.TensorParallel``) what
``current_tp()`` returns while an evaluation runs. It is process-wide, not
a thread's: the backward of a CUDA tensor runs on autograd's device
thread, and a recomputed (checkpointed) layer must see the same split as
its forward. The model reads it once a forward and hands it down.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

_state = threading.local()
_TP = [None]


def _current() -> Optional[Callable]:
    return getattr(_state, "fn", None)


@contextlib.contextmanager
def activation_sharding(fn: Callable):
    """fn(x, kind) -> x (``rules.make_constrain``)."""
    prev = _current()
    _state.fn = fn
    try:
        yield
    finally:
        _state.fn = prev


def constrain(x, kind: str):
    fn = _current()
    if fn is None:
        return x
    return fn(x, kind)


@contextlib.contextmanager
def tensor_parallel(tp):
    """``current_tp()`` is ``tp`` inside the ``with`` (None: no split)."""
    prev = _TP[0]
    _TP[0] = tp
    try:
        yield tp
    finally:
        _TP[0] = prev


def current_tp():
    """The model-axis split of the evaluation under way, or None."""
    return _TP[0]
