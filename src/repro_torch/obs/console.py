"""Process-aware console sink: the one mechanism for run output.

Port of ``repro.obs.console``. ``CONSOLE.print`` emits on the coordinator
only; ``CONSOLE.warn_once`` fires a keyed warning at most once per process,
and only on the coordinator. The coordinator is rank 0 of the
``torch.distributed`` process group when one is initialised, else this
process (``process_index``), asked at call time.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 without
    one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_coordinator() -> bool:
    return process_index() == 0


class Console:
    """Coordinator-gated stdout + a warn-once registry.

    ``active_fn`` overrides the "am I the coordinator?" predicate (tests
    inject a constant); by default ``is_coordinator()``."""

    def __init__(self, active_fn: Optional[Callable[[], bool]] = None):
        self._active_fn = active_fn
        self._warned: set = set()

    def _active(self) -> bool:
        if self._active_fn is not None:
            return self._active_fn()
        return is_coordinator()

    def print(self, *args, **kwargs) -> None:
        """Print on the coordinator process only."""
        if self._active():
            print(*args, **kwargs)

    def warn_once(self, key: str, message: str, *,
                  category=UserWarning, stacklevel: int = 3) -> bool:
        """Emit ``message`` as a warning at most once per ``key`` (and only
        on the coordinator). Returns True the first time the key fires."""
        if key in self._warned:
            return False
        self._warned.add(key)
        if self._active():
            warnings.warn(message, category, stacklevel=stacklevel)
        return True

    def reset(self) -> None:
        """Forget fired warn-once keys (tests)."""
        self._warned.clear()


#: the process-wide console
CONSOLE = Console()
