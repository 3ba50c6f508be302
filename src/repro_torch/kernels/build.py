"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/<name>-<hash>.so``
at the repository root (``REPRO_TORCH_BUILD_DIR`` overrides the directory),
where ``<hash>`` covers the source, the shared headers ``csrc/*.cuh`` and
the compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. ``ptxas -v`` reports each kernel's registers, spills and
static shared memory; the log of a build made by this process is kept in
``LOGS``. ``build_all`` starts one ``nvcc`` per source, all at once. A
library is written under a temporary name and renamed into place, so
processes that build at the same time never load a half-written file.

Nothing is built at import time: the CPU tests import every module, and
this machine may have no ``nvcc``. A missing compiler or a failed build
raises; no caller falls back to a plain version on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fused_xent", "flash_attention", "ssd_scan", "graph_if")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: dict = {}
_LOAD = threading.Lock()
LOGS: dict = {}     # name -> nvcc's output, for the builds of this process


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin):"
                       " the repro_torch CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{key}.so"


def _start(name: str, out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: Path, out: Path):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    LOGS[name] = log
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict:
    """Compile every kernel source that has no current library, one
    ``nvcc`` per source, all started together. -> {name: library path}."""
    outs = {n: _lib_path(n) for n in names}
    running = {n: _start(n, p) for n, p in outs.items() if not p.exists()}
    for n, (proc, tmp) in running.items():
        _finish(n, proc, tmp, outs[n])
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed
    (under a lock: threads of one process never build or load twice)."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD:
            lib = _LIBS.get(name)
            if lib is None:
                path = build_all((name,))[name]
                lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
