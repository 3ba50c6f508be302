"""CUDA-graph IF nodes for the chunked engine's accelerate branch and
Alg. 2 trips: the device tests each predicate at each replay, and the host
reads nothing.

``IfBodies`` makes the IF nodes of one captured step in two passes over
the step, through ``core.isgd.run_if``:

  * ``recording()``, while the step runs eagerly (the engine's warm-up):
    each guarded body is captured as a graph of its own instead of run;
  * ``splicing()``, while the step is captured: each guarded body becomes
    an IF node on its predicate that holds the graph recorded for it, in
    the same order (``csrc/graph_if.cu``; a one-thread kernel sets the
    node's condition from the predicate).

A body is captured ahead of the step because cuDNN's multi-engine
convolutions cannot be captured while another capture is under way (see
the source). So a body may read only tensors that outlive both passes
(parameters, optimizer state, the engine's buffers), never an
intermediate of the step.

Bodies are captured on a stream of their own, one per device, whose
allocations go to a private memory pool of their own, also one per device
and kept for the life of the process: the caching allocator routes each
stream to a pool, and a body's temporaries must stay out of the memory that
eager work and the step's own graph reuse. Bodies run one at a time, each
after the one before in its graph, so all bodies can share that pool.

It needs CUDA 12.4 or later in PyTorch, the driver and the runtime of the
library (``require``); without it the chunked engine raises.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import build

MIN_CUDA = 12040                 # conditional nodes with stream capture
_BODY: dict = {}                 # device index -> (stream, memory pool)
_ACTIVE: list = []               # the IfBodies in a pass, innermost last


def _lib():
    lib = build.load("graph_if")
    if lib.repro_if_node.argtypes is None:    # else pointers go as 32 bits
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn, args in ((lib.repro_capture_begin, [P]),
                         (lib.repro_capture_end, [P, ctypes.POINTER(P)]),
                         (lib.repro_graph_destroy, [P]),
                         (lib.repro_if_node, [P, P, P]),
                         (lib.repro_if_versions, [ctypes.POINTER(I)] * 2)):
            fn.argtypes, fn.restype = args, I
        lib.repro_if_error.argtypes = [I]
        lib.repro_if_error.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"CUDA-graph IF node: {what} failed: "
                           f"{lib.repro_if_error(err).decode()} ({err})")


def _torch_pool_api():
    begin = getattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool", None)
    end = (getattr(torch._C, "_cuda_endAllocateToPool", None)
           or getattr(torch._C, "_cuda_endAllocateCurrentStreamToPool", None))
    return begin, end


def require():
    """Raise unless IF nodes can be captured here: PyTorch built for CUDA
    12.4 or later with per-stream pool routing, and a driver and runtime of
    12.4 or later. -> (driver, runtime) versions, e.g. (12080, 12080)."""
    cuda = tuple(int(x) for x in (torch.version.cuda or "0.0").split(".")[:2])
    if cuda < (12, 4) or None in _torch_pool_api():
        raise RuntimeError(
            f"the chunked engine on CUDA needs CUDA-graph conditional nodes: "
            f"torch {torch.__version__} built for CUDA {torch.version.cuda} "
            f"cannot capture them (CUDA >= 12.4 and per-stream allocation "
            f"pools needed). It does not fall back to host reads: use the "
            f"per-step engine")
    lib = _lib()
    driver, runtime = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.repro_if_versions(ctypes.byref(driver),
                                      ctypes.byref(runtime)), "versions")
    if min(driver.value, runtime.value) < MIN_CUDA:
        raise RuntimeError(
            f"the chunked engine on CUDA needs CUDA-graph conditional nodes "
            f"(CUDA >= 12.4); driver {driver.value}, runtime {runtime.value}. "
            f"It does not fall back to host reads: use the per-step engine")
    return driver.value, runtime.value


def active():
    """The ``IfBodies`` whose pass is under way, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class IfBodies:
    """The IF nodes of one captured step on ``device`` (module doc)."""

    def __init__(self, device):
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.lib = _lib()
        self.graphs: list = []     # recorded bodies (cudaGraph_t), in order
        self.mode = None
        self.recorded = self.spliced = 0

    @contextlib.contextmanager
    def _pass(self, mode: str):
        self.mode = mode
        _ACTIVE.append(self)
        try:
            yield self
        finally:
            _ACTIVE.pop()
            self.mode = None

    def recording(self):
        return self._pass("record")

    @contextlib.contextmanager
    def splicing(self):
        self.spliced = 0
        try:
            with self._pass("splice"):
                yield self
        finally:
            while self.graphs:     # the node holds a copy; drop the rest too
                self.lib.repro_graph_destroy(self.graphs.pop())
        if self.spliced != self.recorded:
            raise RuntimeError(f"the step guarded {self.spliced} bodies when "
                               f"captured and {self.recorded} when recorded")

    def guard(self, pred, body):
        """``run_if``'s work during a pass."""
        if self.mode == "record":
            self._record(body)
        else:
            self._splice(pred)

    def _record(self, body):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("IF bodies are recorded while the step runs "
                               "eagerly, not while it is captured")
        stream, pool = _body_stream(self.device)
        begin_pool, end_pool = _torch_pool_api()
        _check(self.lib, self.lib.repro_capture_begin(stream.cuda_stream),
               "capture begin")
        graph = ctypes.c_void_p()
        try:
            with torch.cuda.stream(stream):
                begin_pool(self.device.index, pool)
                try:
                    body()
                finally:
                    end_pool(self.device.index, pool)
        finally:
            err = self.lib.repro_capture_end(stream.cuda_stream,
                                             ctypes.byref(graph))
        _check(self.lib, err, "capture end")
        self.graphs.append(graph)
        self.recorded = len(self.graphs)

    def _splice(self, pred):
        if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
            raise TypeError("an IF node takes a 0-d bool CUDA tensor")
        if self.spliced >= len(self.graphs):
            raise RuntimeError("the step guards more bodies when captured "
                               "than it did when recorded")
        outer = torch.cuda.current_stream(self.device)
        _check(self.lib, self.lib.repro_if_node(
            pred.data_ptr(), outer.cuda_stream, self.graphs[self.spliced]),
            "node")
        self.spliced += 1


def _body_stream(device):
    hit = _BODY.get(device.index)
    if hit is None:
        hit = _BODY[device.index] = (torch.cuda.Stream(device),
                                     torch.cuda.graph_pool_handle())
    return hit
