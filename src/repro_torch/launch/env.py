"""Process environment: the ``torch.distributed`` process group.

Port of the process half of ``repro.launch.env``. The reference's
XLA-flag helpers (``apply_xla_flags``, ``apply_async_collective_flags``,
``force_host_device_count``) have no counterpart: PyTorch reads no
``XLA_FLAGS``, a process owns its device by ``torch.cuda.set_device``, and
the collective implementation is the process group's backend.

:func:`initialize_distributed` makes the process group once:

  * from ``--coordinator host:port --num-processes N --process-id r``
    (``tcp://host:port``), or from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
  * with ``nccl`` for a CUDA device and ``gloo`` for the CPU; ``backend=
    "gloo"`` (the launcher's ``--dist-backend gloo``) picks gloo for CUDA
    tensors too, which is how several ranks share one card (NCCL refuses
    two ranks on one device);
  * idempotently: a second call with the same arguments returns the
    first's topology, one with different arguments raises, because a
    half-switched process group is undebuggable.

A single-process call (no coordinator, no ``torchrun`` environment) makes
no group and returns the trivial topology, as in the reference; the
data-parallel engine still needs a group to gather over, and
:func:`ensure_group` makes a one-rank group over an in-process store for
it (``launch.mesh.make_data_mesh`` calls it).

:func:`spawn_ranks` runs a function on N fresh processes, one rank each,
joined by a file store (no network), and returns their results; a rank
that fails or outlives its timeout fails the call (the parity harnesses'
``--procs N`` and the tests use it).

CLI wiring: ``add_process_args`` / ``initialize_from_args``:

    PYTHONPATH=src python -m repro_torch.launch.train ... \\
        --coordinator 127.0.0.1:12345 --num-processes 2 --process-id 0
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional

import torch

#: how long a rank waits for the others at rendezvous and in a collective
TIMEOUT = datetime.timedelta(seconds=600)


@dataclass(frozen=True)
class ProcessTopology:
    """The process grid a run executes on."""

    process_id: int = 0
    num_processes: int = 1
    coordinator: Optional[str] = None
    backend: Optional[str] = None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


_TOPOLOGY: Optional[ProcessTopology] = None


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _set_device(device, process_id: int):
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = process_id % torch.cuda.device_count()
        torch.cuda.set_device(index)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda", backend: Optional[str] = None,
                           timeout: datetime.timedelta = TIMEOUT,
                           ) -> ProcessTopology:
    """Make the process group (module doc). ``device`` picks the default
    backend and, for CUDA, this rank's card (``process_id`` modulo the
    cards, when the device names none). Returns the topology."""
    global _TOPOLOGY
    env = os.environ
    if coordinator is None and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    if coordinator is None and (num_processes or 1) == 1:
        return _TOPOLOGY or ProcessTopology()
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("--coordinator needs both --num-processes and "
                         "--process-id")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"--process-id {process_id} is outside "
                         f"[0, {num_processes})")
    backend = backend or default_backend(device)
    topo = ProcessTopology(process_id=int(process_id),
                           num_processes=int(num_processes),
                           coordinator=coordinator, backend=backend)
    if _TOPOLOGY is not None:
        if _TOPOLOGY != topo:
            raise RuntimeError(
                f"torch.distributed already initialized as {_TOPOLOGY}; "
                f"cannot re-initialize as {topo}")
        return _TOPOLOGY
    import torch.distributed as dist
    _set_device(device, topo.process_id)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=topo.num_processes,
                            rank=topo.process_id, timeout=timeout)
    _TOPOLOGY = topo
    return topo


def ensure_group(device="cuda", backend: Optional[str] = None,
                 ) -> ProcessTopology:
    """The process group, made as a one-rank group over an in-process store
    when none exists (a single-process data-parallel run); a group made
    before (by ``initialize_distributed``, ``torchrun`` or the caller) is
    used as it is."""
    global _TOPOLOGY
    import torch.distributed as dist
    if dist.is_initialized():
        return topology()
    backend = backend or default_backend(device)
    _set_device(device, 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=TIMEOUT)
    _TOPOLOGY = ProcessTopology(backend=backend)
    return _TOPOLOGY


@contextlib.contextmanager
def local_group(device="cuda", backend: Optional[str] = None):
    """``ensure_group`` for the length of a ``with``: a one-rank group made
    here is destroyed at its end; a group that existed is left alone."""
    global _TOPOLOGY
    import torch.distributed as dist
    made = not dist.is_initialized()
    saved = _TOPOLOGY
    ensure_group(device, backend)
    try:
        yield topology()
    finally:
        if made:
            dist.destroy_process_group()
            _TOPOLOGY = saved


def _rank_main(target, rank, world, store, device, backend, timeout, args,
               results):
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        backend = backend or default_backend(device)
        _set_device(device, rank)
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, True, target(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:               # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(target: Callable, world: int, *args, device="cuda",
                backend: Optional[str] = None,
                timeout: float = 300.0) -> list:
    """Run ``target(rank, world, *args)`` on ``world`` fresh processes
    (``spawn``), each rank of one group (``backend``, default by
    ``device``; the card unless ``device="cpu"`` is passed, and without a
    card that raises here, before any rank starts) joined through a file
    store in a temporary directory.
    ``target`` and ``args`` must pickle (a module-level function). Returns
    the ranks' results in rank order; raises ``RuntimeError`` with the
    tracebacks if a rank fails, and kills every rank still running after
    ``timeout`` seconds."""
    import multiprocessing as mp

    from repro_torch.device import resolve_device
    resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got, procs = {}, []
    with tempfile.TemporaryDirectory(prefix="ranks_") as d:
        store = os.path.join(d, "store")
        try:
            for r in range(world):
                p = ctx.Process(target=_rank_main, daemon=True,
                                args=(target, r, world, store, device,
                                      backend, timeout, args, results))
                p.start()
                procs.append(p)
            deadline = time.monotonic() + timeout
            while len(got) < world and time.monotonic() < deadline:
                try:
                    r, ok, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [p for i, p in enumerate(procs)
                            if i not in got and p.exitcode not in (None, 0)]
                    if dead:
                        time.sleep(0.5)           # a last report in flight
                        while not results.empty():
                            r, ok, value = results.get()
                            got[r] = (ok, value)
                        break
                    continue
                got[r] = (ok, value)
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    failed = {r: v for r, (ok, v) in got.items() if not ok}
    missing = [r for r in range(world) if r not in got]
    if failed or missing:
        lines = [f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())]
        if missing:
            lines.append(f"ranks {missing} gave no result within "
                         f"{timeout:.0f} s (exit codes "
                         f"{[procs[r].exitcode for r in missing]})")
        raise RuntimeError("\n".join(lines))
    return [got[r][1] for r in range(world)]


def topology() -> ProcessTopology:
    """The current topology: the group's rank and size when one exists,
    else the recorded arguments (the trivial topology)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return ProcessTopology(
            process_id=dist.get_rank(), num_processes=dist.get_world_size(),
            coordinator=_TOPOLOGY.coordinator if _TOPOLOGY else None,
            backend=dist.get_backend())
    return _TOPOLOGY or ProcessTopology()


def is_coordinator() -> bool:
    """True on the process that owns logging and checkpoint writing."""
    return topology().is_coordinator


def p0print(*args, **kwargs) -> None:
    """Print on process 0 only (``repro_torch.obs.console.CONSOLE``)."""
    from repro_torch.obs.console import CONSOLE
    CONSOLE.print(*args, **kwargs)


def add_process_args(parser) -> None:
    """The shared ``--coordinator/--num-processes/--process-id`` surface,
    and ``--dist-backend``."""
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0's rendezvous; presence "
                             "switches the run to multi-process "
                             "(torch.distributed.init_process_group)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="total process count of the multi-process run")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's index in [0, num_processes)")
    parser.add_argument("--dist-backend", default=None,
                        choices=["nccl", "gloo"],
                        help="process-group backend (default nccl on CUDA, "
                             "gloo on the CPU; gloo lets several ranks "
                             "share one card)")


def initialize_from_args(args, device="cuda") -> ProcessTopology:
    """``add_process_args`` namespace -> initialized topology (no group for
    a single-process run)."""
    return initialize_distributed(coordinator=args.coordinator,
                                  num_processes=args.num_processes,
                                  process_id=args.process_id, device=device,
                                  backend=args.dist_backend)
