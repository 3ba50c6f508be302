#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` and shows from ptxas and the SASS how each
was compiled (``wgmma`` and TMA in the bf16 routes of all three), holds
each kernel against its plain PyTorch version on the card, times kernel,
plain version and library call by device time
(``cuda_ms``), and drives the port's three zoo training paths
through the launcher with ``--kernels cuda``: ``paper-transformer`` (base
tier, 16 layers), ``paper-ssm`` (base tier, 24 Mamba2/SSD layers) and
``paper-moe`` (base tier, 12 attention layers, GShard top-2 MoE of 8
experts on every second), all at full width for 12 ISGD steps. For each
path it checks that the run launched exactly that path's kernels,
compares step 1's loss with the model's plain paths (and layer 0's
mixer, kernel against plain, at the path's shape), and profiles three
steps. Then each path runs again through the fused engine
(``--chunk-steps 4``: a CUDA graph of one step, the accelerate branch
and the Alg. 2 trips in IF nodes, K replays per chunk), once more with
K = 1 on the transformer, and is held against its per-step run: the same
accelerate and sub_iters sequences and every loss equal, bit for bit.
Three chunks of each are profiled, one profiler
cycle a chunk, in a child process of this script
(``--profile-chunked PATH SPEC``); there the wrappers count their launches
on the device (``repro_torch.kernels.launch_count``: a graph replays its
kernels without passing through the wrappers' host counters), and the
profiler's own count of each kernel is printed beside it. Then
``arch_reduced`` trains each of the ten
assigned architectures' reduced configs for 3 steps (exact launches of
its layer plan, step-1 loss against the plain paths within ARCH_PARITY),
and ``chunked_arch`` holds the fused engine bit for bit against the
per-step engine on reduced DeepSeek-V2-Lite (MLA, a dense prefix, shared
experts) and Jamba (SSM and attention layers, MoE). The paper's
``alexnet-small`` CNN (64 × 64 × 3, 1000 classes, f32 without TF32,
batch 256) trains 24 steps through the per-step engine and again through
the fused engine. Then the training loop's surface: ``obs`` runs 8
transformer steps per engine without and with ``--obs-dir`` (the SPC
chart reconciled with the engine's queue bit for bit, the JSONL valid,
the two runs bit-identical), ``micro_batches`` captures the fused step at
``micro_batches=2`` against the per-step engine, ``profile_dir`` writes
``--profile-dir`` traces holding the kernels' names and the ``obs/*``
spans, and ``eval_cnn`` trains ``cifar-quick`` (32 × 32 × 3) with ISGD and
with SGD, evaluating every epoch with measured walls, and the ISGD leg
again through the fused engine, whose Alg. 2 trips run in IF nodes around
cuDNN convolutions. Then the batch schedules and checkpoints on the
transformer path: ``sched`` trains with ``--schedule fcpr`` through the
fused engine (bit for bit the unscheduled fused run) and with ``--schedule
loss-prop`` per-step and fused (bit for bit each other, batch picks
included; the selection inside the graph, the launches counted on the
device), and ``resume`` kills a ``loss-prop`` run at a checkpoint (step 6,
K = 3) and resumes it in a fresh process with K = 4, on the uninterrupted
run's trajectory and final state bit for bit (each run a child process of
this script, ``--launch OUT SPEC ARGS``). Then data parallelism
(``repro_torch.distributed``, ``--engine data-parallel``, each run or rank
a child process through ``--launch`` too): ``dp`` trains the transformer on
one NCCL rank, per-step and fused (K = 4, the collectives inside the CUDA
graph and its IF nodes), each bit for bit with the single-device run of
its engine (losses, ψ̄, limits, decisions, trips) with the same launches,
its ms/step beside the single-device figure; ``dp2`` trains it on two
ranks sharing the card over gloo, 4 rows a rank, with the replicas
checksummed alike after every step, every reduction's received segments
the ranks' own, each mean the f32 rank-order mean of them and each ψ the
f32 mean of the shards' bit for bit, and each
rank's ψ within the bf16 ``fused_xent`` tolerance of the single-device
run; ``dp_parity`` runs
``python -m repro_torch.distributed.parity`` with two gloo ranks and one
NCCL rank. Then the hybrid DP × TP engine, the pod axis and the zoo
parity matrix: ``hybrid`` trains ``paper-transformer`` base at full width
and depth through ``--engine hybrid --model-parallel 2`` on two gloo ranks
sharing the card (a ``(data=1, model=2)`` mesh: 8 query and 4 KV heads of
every layer and half of every MLP a rank), 4 per-step steps, each rank's
ψ within the bf16 tolerance of the single-device run, the ranks' logs and
replicated tensors (and at the end the whole params, gathered) bit for
bit, each rank's launches counted on the device (32 ``flash_attention``
and 1 ``fused_xent`` an evaluation), with s/step, peak and the bytes the
tensor-parallel collectives move; ``hybrid_gqa`` makes the same checks on
the head plan's KV groups: ``starcoder2_3b`` at full width cut to two
layers, on four gloo ranks on ``(data=1, model=4)`` (6 query heads
against one KV head a rank, KV groups of two ranks) beside a
single-device run of the same config, and rank 0's step-1 gradient of
every attention leaf within 5 % of that run's; ``hybrid_moe`` makes them
on the MoE split: ``paper-moe`` at full width cut to four layers (two
MoE), four gloo ranks on ``(1, 4)`` (expert parallel, 2 experts a rank)
and three on ``(1, 3)`` (within each expert, 512 of ``moe_d_ff`` a
rank), each rank's MoE compute shapes, and rank 0's step-1 gradient of
the routers and experts within 5 % of a single-device run's
(``--tp-only`` runs the device line, the build, the kernel checks at
``hybrid_gqa``'s and ``hybrid_moe``'s shapes, ``train``, ``hybrid``,
``hybrid_gqa`` and ``hybrid_moe``);
``hybrid_parity``, ``multihost_parity``
and ``zoo_parity`` run the three harnesses on the card (gloo ranks, and
one NCCL rank for the fused legs; the zoo's kernel leg is ``--kernels
cuda`` against ``reference``). Then the asynchronous parameter server
(``repro_torch.distributed.async_ps``, ``--engine async-ps``; worker
threads of one process, every thread on the default stream):
``async_ps`` trains ``paper-transformer`` base with one worker at
staleness 0 for 12 pushes, bit for bit the ``train`` run (log, final
params and velocity, device-counted launches), ms a push beside its
ms/step; ``async_ps2`` with two workers at staleness 1, every τ within 3,
each worker on its stripe ``k·2 + w``, each pulled snapshot checksummed
on the device at its pull and when its push lands (equal: no thread wrote
it); ``async_resume`` kills the one-worker run at its push-6 checkpoint
and resumes it in a fresh process, bit for bit, the final checkpoint
array by array; ``async_faults`` runs ``paper-transformer`` tiny with
``--verify-pushes`` in four fresh processes at once (an elastic run
surviving a crash and a hang past the deadline, re-striped; corrupt and
transient pushes retried bit for bit; a non-elastic stall exiting with
``WorkerStalled``); ``async_parity`` runs the harness on the card. Then
serving (``repro_torch.serve``, which runs the plain paths, as the
reference serves without its kernels):
``serve`` drives ``paper-transformer`` base through the serve launcher's
continuous engine (48 mixed-length requests on 16 slots of 1024
positions) and holds the decode step's CUDA graph, captured once, bit for
bit against eager decode of the same slot state, the run's tokens against
the one-shot path (a divergence is excused only where the one-shot
top-2 logit margin is below the bf16 tolerance), and three requests'
prefill and first decode steps against the full forward;
``serve_oneshot`` times the one-shot engine at batch 16; ``serve_ssm``
and ``serve_moe`` serve ``paper-ssm`` and ``paper-moe`` base (graph
against eager; the SSM against one-shot; the MoE's capacity drops);
``serve_arch`` holds each reduced architecture's cached decode against
its full forward; ``train_and_serve`` serves while a trainer child
publishes snapshots, hot-swapping them between decode steps.
``--serve-only`` runs the device line and the serving phases alone,
``--async-only`` the device line, the build, ``train`` and the async
phases. ``analysis`` holds the analysis tier's meta-device count of one
``paper-transformer`` base evaluation against the card's own run of it
(FLOPs, launches, device time against the roofline's compute time, peak
memory); ``--analysis-only`` runs the device line, the build, ``train``
and ``analysis``. The phases that run only child processes (``resume``,
``dp``, ``dp2``, ``hybrid``, ``hybrid_gqa``, ``hybrid_moe``, the parity
harnesses but ``async_parity``, and ``async_resume``) run four at a time, after ``sched``, ``async_ps``
and ``async_ps2`` and before ``async_faults`` (``child_phases``); every
other phase runs alone on the card. Each phase prints one JSON line, with ``at_s``, the
seconds since its process started; the last two lines are the kernels
summary and ``{"ok": true, "device": {...}}``.

Nothing is caught: any failure exits nonzero before the last line. Without
a CUDA device, or outside a checkout of the repository, it exits nonzero
and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from functools import partial

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

MEM_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense tensor-core bf16
              torch.float32: 67e12}        # f32 outside the tensor cores
DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

MODELS = ("transformer", "ssm", "moe")     # the training paths, in order
SUFFIX = {"transformer": "", "ssm": "_ssm", "moe": "_moe"}  # phase names
XENT_MAIN = (8192, 1024, 32768, 32768)     # N = B·S, d, Vp, vocab
ATTN_MAIN = (8, 1024, 16, 8, 64)           # B, S, H, K, hd (causal)
SSD_MAIN = (8, 1024, 32, 64, 1, 128, 256)  # b, S, nh, hd, G, ds, chunk
SSD_MAMBA2 = (1, 2048, 80, 64, 1, 128, 256)  # Mamba2-2.7B's mixer
GQA_ATTN = ((8, 1024, 6, 1, 128),          # a hybrid_gqa rank: rep 6
            (8, 1024, 24, 2, 128))         # its single-device run
GQA_XENT = (8192, 3072, 49152, 49152)      # starcoder2_3b's tied head
DT_INIT = math.log(math.expm1(0.01))       # dt_bias at init: dt ≈ 0.01–0.02
PARITY_TIGHT = 1e-3                        # step-1 loss, relative
CHUNK = 4                                  # K of the fused runs


def train_args(model: str, steps: int = 12) -> list:
    """The training run: --batch 8 --seq 1024 on the base tier."""
    return ["--model", model, "--tier", "base", "--kernels", "cuda",
            "--precision", "bf16", "--batch", "8", "--seq", "1024",
            "--n-seqs", "32", "--steps", str(steps), "--k-sigma", "1.0",
            "--stop", "3", "--device", "cuda"]


T0 = time.perf_counter()                   # this process's start, for ``at_s``
_EMIT = threading.Lock()


def emit(phase: str, **fields):
    """One JSON line for a phase, with ``at_s``, the seconds since this
    process started; one write under a lock, as phases run in threads
    too."""
    line = json.dumps({"phase": phase, **fields,
                       "at_s": time.perf_counter() - T0})
    with _EMIT:
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


SLEEP_HZ = 2.0e9                           # cycles per second of torch.cuda._sleep, at most


def cuda_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Device time of one call: CUDA events around ``reps`` back-to-back
    calls, all enqueued while the device still runs a sleep kernel, so the
    device never waits on the host between them and no host work (checks,
    allocation, ctypes, dispatch) is in the time. If the sleep ended before
    the host had enqueued the last call, it is doubled and the run made
    again. The same timer serves kernel, plain and library calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_s = max(0.02, 2 * reps * host_s)
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        ahead = not a.query()      # still asleep after the last enqueue
        b.synchronize()
        if ahead:
            return a.elapsed_time(b) / reps
        sleep_s *= 2
    raise SystemExit("cuda_ms: the host could not enqueue ahead of the device")


def compare(out, ref, tol) -> dict:
    """allclose(out, ref, rtol, atol) with the errors it saw; max_rel is
    taken over the elements whose reference exceeds atol."""
    rtol, atol = tol
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    big = ref.abs() > atol
    max_rel = float((err[big] / ref.abs()[big]).max()) if bool(big.any()) else 0.0
    ok = bool(torch.all(err <= atol + rtol * ref.abs()))
    return {"max_abs": float(err.max()), "max_rel": max_rel,
            "rtol": rtol, "atol": atol, "ok": ok}


def bound_ms(ops: float, nbytes: float, dtype) -> tuple:
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# ---------------------------------------------------------------------------
# inputs (numpy from a seed, as the CPU tests make them)
# ---------------------------------------------------------------------------
def xent_inputs(N, d, Vp, V, dtype, tied=False, seed=0):
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(N, d).astype(np.float32))
    w = torch.from_numpy((rng.randn(d, Vp) * 0.05).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, V, size=N).astype(np.int32))
    h, w, y = h.cuda().to(dtype), w.cuda().to(dtype), y.cuda()
    if tied:                       # a tied head: W is embed.T, a strided view
        w = w.T.contiguous().T
    return h, w, y


def attn_inputs(B, S, H, K, hd, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, S, n, hd).astype(np.float32))
            .cuda().to(dtype) for n in (H, K, K)]


def ssd_inputs(b, S, nh, hd, G, ds, dtype, seed=0, dt_shift=0.0):
    """x, B and C as views of one (b, S, nh·hd + 2·G·ds) tensor, the
    model's layout after the convolution; dt = softplus(N(dt_shift, 1)) and
    A = −exp(0.3·N(0,1)) in f32, as the kernel-numerics grid draws them.
    At dt_shift = DT_INIT dt is the model's at init, small enough that every
    64-position tile of a 256-long chunk, and the chunk's decay, weigh above
    the tolerance; at dt_shift = 0 (mean 0.8) only the last tile does."""
    rng = np.random.RandomState(seed)
    di = nh * hd
    xBC = torch.from_numpy(rng.randn(b, S, di + 2 * G * ds)
                           .astype(np.float32)).cuda().to(dtype)
    dt = np.log1p(np.exp(rng.randn(b, S, nh) + dt_shift)).astype(np.float32)
    A = (-np.exp(rng.randn(nh) * 0.3)).astype(np.float32)
    return (xBC[..., :di].reshape(b, S, nh, hd), torch.from_numpy(dt).cuda(),
            torch.from_numpy(A).cuda(),
            xBC[..., di:di + G * ds].reshape(b, S, G, ds),
            xBC[..., di + G * ds:].reshape(b, S, G, ds))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    from repro_torch.kernels import build
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()
    emit("device", nvidia_smi=smi.splitlines()[0],
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.splitlines()[-1], python=sys.version.split()[0])
    return smi.splitlines()[0]


# the route each kernel's bf16 path takes, and the SASS that shows it
DESIGN = {"fused_xent": "wgmma+tma", "flash_attention": "wgmma+tma",
          "ssd_scan": "wgmma+tma",
          "graph_if": "CUDA-graph IF node: stream-capture helper and the "
                      "one-thread kernel that sets its condition"}
BF16_KERNEL = {"fused_xent": "xent_partial_bf16",
               "flash_attention": "flash_fwd_bf16",
               "ssd_scan": "ssd_chunk_bf16"}
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "WARPGROUP.DEPBAR")


def ptxas_report(log: str) -> dict:
    """{kernel: registers, stack, spills and static shared memory, and any
    ptxas warning that it serialised the kernel's wgmma} from the
    ``-Xptxas -v`` lines of one nvcc run."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if "wgmma" in line and "serialized" in line:
            m = re.search(r"function '(\w+)'", line)
            target = out.setdefault(m.group(1), {}) if m else cur
            if target is not None:
                target["ptxas_warning"] = line.strip()[-200:]
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            cur["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_static"] = int(sm.group(1)) if sm else 0
    return out


def sass_counts(lib: str) -> dict:
    """{kernel: counts of HGMMA (wgmma), UTMALDG (TMA load), HMMA
    (mma.sync) and WARPGROUP.DEPBAR (a wait for wgmma; one after every
    HGMMA means they run one at a time) instructions} in a library's SASS,
    or {} without cuobjdump."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = out.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
        elif cur is not None:
            for op in cur:
                if re.search(rf"\b{re.escape(op)}\b", line):
                    cur[op] += 1
    return out


def demangle(names) -> dict:
    names = list(names)
    if not names or shutil.which("c++filt") is None:
        return {n: n for n in names}
    plain = subprocess.run(["c++filt"], input="\n".join(names), check=True,
                           capture_output=True, text=True).stdout.splitlines()
    return {n: p.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for n, p in zip(names, plain)}


def phase_build():
    """Builds every source (one nvcc each, in parallel), then prints one
    line per source with each kernel's registers, spills and static shared
    memory (ptxas -v) and its HGMMA / UTMALDG / HMMA / WARPGROUP.DEPBAR
    counts (cuobjdump). The bf16 route of every kernel must show wgmma and
    TMA, no mma.sync and no register spills."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in libs:
        build.load(name)
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()})
    for name, lib in libs.items():
        regs = ptxas_report(build.LOGS.get(name, ""))
        sass = sass_counts(str(lib))
        pretty = demangle(set(regs) | set(sass))
        kernels = {pretty[k]: {**regs.get(k, {}), **sass.get(k, {})}
                   for k in sorted(set(regs) | set(sass))}
        emit("build_evidence", source=f"src/repro_torch/kernels/csrc/{name}.cu",
             design=DESIGN[name], kernels=kernels)
        if sass and name in BF16_KERNEL:
            routes = {k: c for k, c in kernels.items() if BF16_KERNEL[name] in k}
            if not routes or not all(c["HGMMA"] and c["UTMALDG"] and not c["HMMA"]
                                     and not c.get("spill_stores")
                                     for c in routes.values()):
                raise SystemExit(f"{name}: expected wgmma and TMA, no mma.sync and "
                                 f"no spills in {BF16_KERNEL[name]}: {routes}")


def check_xent(shape, dtype, tied=False, timed=False) -> dict:
    from repro_torch.kernels.fused_xent import fused_xent, xent_plain
    from repro_torch.kernels.numerics import TOLERANCES
    N, d, Vp, V = shape
    h, w, y = xent_inputs(N, d, Vp, V, dtype, tied)
    out = fused_xent(h, w, y, V)
    torch.cuda.synchronize()
    res = {"kernel": "fused_xent", "shape": list(shape), "tied": tied,
           "dtype": DTYPE_NAME[dtype],
           **compare(out, xent_plain(h, w, y, V),
                     TOLERANCES["fused_xent"][DTYPE_NAME[dtype]])}
    if timed:
        from repro_torch.kernels.fused_xent.kernel import cost
        y64 = y.long()
        ops, nbytes = cost(N, d, Vp, dtype)
        res["bound_ms"], res["bound_by"] = bound_ms(ops, nbytes, dtype)
        res["kernel_ms"] = cuda_ms(lambda: fused_xent(h, w, y, V))
        res["plain_ms"] = cuda_ms(lambda: xent_plain(h, w, y, V))
        # yardstick: one cuBLAS product into materialized logits, then
        # PyTorch's cross-entropy (valid where vocab == Vp)
        res["library_ms"] = (cuda_ms(lambda: F.cross_entropy(
            (h @ w).float(), y64, reduction="none")) if V == Vp else None)
        res["achieved_tflops"] = ops / res["kernel_ms"] / 1e9
        res["bound_share"] = res["bound_ms"] / res["kernel_ms"]
    emit("check", **res)
    if not res["ok"]:
        raise SystemExit(f"fused_xent disagrees with its plain version: {res}")
    return res


def check_attn(shape, dtype, causal=True, window=None, timed=False) -> dict:
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    from repro_torch.kernels.numerics import TOLERANCES
    B, S, H, K, hd = shape
    q, k, v = attn_inputs(B, S, H, K, hd, dtype)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    res = {"kernel": "flash_attention", "shape": list(shape), "causal": causal,
           "window": window, "dtype": DTYPE_NAME[dtype],
           **compare(out, attention_plain(q, k, v, causal=causal, window=window),
                     TOLERANCES["flash_attention"][DTYPE_NAME[dtype]])}
    if timed:
        from repro_torch.kernels.flash_attention.kernel import cost
        ops, nbytes = cost(B, S, S, H, K, hd, dtype, causal, window)
        res["bound_ms"], res["bound_by"] = bound_ms(ops, nbytes, dtype)
        res["kernel_ms"] = cuda_ms(
            lambda: flash_attention(q, k, v, causal=causal, window=window))
        res["plain_ms"] = cuda_ms(
            lambda: attention_plain(q, k, v, causal=causal, window=window))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        res["library_ms"] = (cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
            if causal and window is None else None)
        res["achieved_tflops"] = ops / res["kernel_ms"] / 1e9
        res["bound_share"] = res["bound_ms"] / res["kernel_ms"]
    emit("check", **res)
    if not res["ok"]:
        raise SystemExit(f"flash_attention disagrees with its plain version: {res}")
    return res


def check_ssd(shape, dtype, timed=False, dt_shift=0.0) -> dict:
    """The kernel's three outputs against its plain version on the chunked
    views, then the whole ``ssd_chunked_kernel`` (y, final state) against
    the plain ``ssd_chunked``."""
    from repro_torch.kernels.numerics import TOLERANCES
    from repro_torch.kernels.ssd_scan import (chunk_len, ssd_chunked_kernel,
                                              ssd_intra_chunk,
                                              ssd_intra_chunk_plain)
    from repro_torch.models.ssm import ssd_chunked
    b, S, nh, hd, G, ds, chunk = shape
    x, dt, A, B, C = ssd_inputs(b, S, nh, hd, G, ds, dtype, dt_shift=dt_shift)
    cl = chunk_len(S, chunk)
    N = b * S // cl
    ins = (x.reshape(N, cl, nh, hd), dt.reshape(N, cl, nh), A,
           B.reshape(N, cl, G, ds), C.reshape(N, cl, G, ds))
    tol = TOLERANCES["ssd_scan"][DTYPE_NAME[dtype]]
    outs = ssd_intra_chunk(*ins)
    torch.cuda.synchronize()
    parts = [compare(o, r, tol) for o, r in zip(outs, ssd_intra_chunk_plain(*ins))]
    parts += [compare(o, r, tol) for o, r in zip(
        ssd_chunked_kernel(x, dt, A, B, C, chunk=chunk),
        ssd_chunked(x, dt, A, B, C, chunk=chunk))]
    res = {"kernel": "ssd_scan", "shape": list(shape), "chunk_len": cl,
           "dt_shift": dt_shift, "dtype": DTYPE_NAME[dtype],  # the kernel's outputs:
           "max_abs": max(p["max_abs"] for p in parts[:3]),
           "max_rel": max(p["max_rel"] for p in parts[:3]),
           "max_abs_by_output": dict(zip(
               ("y_diag", "states", "decays", "y", "final_state"),
               (p["max_abs"] for p in parts))),
           "rtol": tol[0], "atol": tol[1], "ok": all(p["ok"] for p in parts)}
    if timed:
        from repro_torch.kernels.ssd_scan.kernel import cost
        ops, nbytes = cost(N, cl, nh, hd, G, ds, dtype)
        res["bound_ms"], res["bound_by"] = bound_ms(ops, nbytes, dtype)
        res["kernel_ms"] = cuda_ms(lambda: ssd_intra_chunk(*ins))
        res["plain_ms"] = cuda_ms(lambda: ssd_intra_chunk_plain(*ins))
        res["library_ms"] = None      # no single PyTorch call computes it
        res["achieved_tflops"] = ops / res["kernel_ms"] / 1e9
        res["bound_share"] = res["bound_ms"] / res["kernel_ms"]
    emit("check", **res)
    if not res["ok"]:
        raise SystemExit(f"ssd_scan disagrees with its plain version: {res}")
    return res


def phase_checks() -> dict:
    """Every kernel vs its plain version, f32 and bf16: the main paths'
    shapes (timed), the ragged grid cells of the CPU tests, the edges of
    the wgmma + TMA routes (as ``tests/test_torch_cuda.py`` has them) and
    the tiny tiers. -> {kernel: the timed bf16 main-shape result}."""
    from repro_torch.kernels.numerics import (ATTN_EDGES, ATTN_SHAPES,
                                              SSD_EDGES, SSD_SHAPES,
                                              XENT_EDGES, XENT_SHAPES,
                                              gqa_split)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        main["fused_xent"] = check_xent(XENT_MAIN, dtype, timed=True)
        for shape in XENT_SHAPES:
            check_xent(shape, dtype)
        check_xent((1024, 64, 256, 256), dtype, tied=True)   # tiny tier's head
        for N, d, Vp, V, tied in XENT_EDGES:
            check_xent((N, d, Vp, V), dtype, tied=tied)
        main["flash_attention"] = check_attn(ATTN_MAIN, dtype, timed=True)
        for BH, S, hd, causal, window in ATTN_SHAPES:
            B, H, K = gqa_split(BH)
            check_attn((B, S, H, K, hd), dtype, causal=causal, window=window)
        check_attn((2, 256, 8, 2, 128), dtype)                # hd = 128
        check_attn((8, 128, 4, 2, 16), dtype)                 # tiny tier
        for B, S, H, K, hd, causal, window in ATTN_EDGES:
            check_attn((B, S, H, K, hd), dtype, causal=causal, window=window)
        check_gqa_shapes(dtype)
        check_moe_shapes(dtype)
        main["ssd_scan"] = check_ssd(SSD_MAIN, dtype, timed=True,
                                     dt_shift=DT_INIT)
        for shape in SSD_SHAPES:
            check_ssd(shape, dtype)
        check_ssd((1, 100, 2, 16, 1, 8, 32), dtype)           # cl = 25
        check_ssd((2, 128, 4, 32, 2, 16, 64), dtype)          # two groups
        check_ssd(SSD_MAMBA2, dtype, dt_shift=DT_INIT,        # timed in bf16
                  timed=dtype == torch.bfloat16)
        for *shape, init_dt in SSD_EDGES:
            check_ssd(tuple(shape), dtype, dt_shift=DT_INIT if init_dt else 0.0)
    return main                    # the bf16 entries: the training dtype


def check_gqa_shapes(dtype) -> None:
    """``hybrid_gqa``'s kernel shapes (``starcoder2_3b``, batch 8 × seq
    1024) against the plain versions: ``flash_attention`` on a rank's 6
    query heads over one KV head and on the single-device run's 24 over 2,
    ``fused_xent`` on the tied head."""
    for shape in GQA_ATTN:
        check_attn(shape, dtype)
    check_xent(GQA_XENT, dtype, tied=True)


def check_moe_shapes(dtype) -> None:
    """``hybrid_moe``'s own kernel shape: ``flash_attention`` on a
    ``(1, 4)`` rank's 3 query heads over one KV head (``paper-moe``, batch
    8 × seq 1024) against the plain version. The ``(1, 3)`` ranks and the
    single-device run attend at ``paper-moe``'s own shape
    (``numerics.ATTN_EDGES``), the head at ``XENT_MAIN``'s."""
    check_attn(MOE_ATTN, dtype)


def phase_train(model: str) -> dict:
    from repro_torch.configs import zoo_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_xent import fused_xent
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk
    from repro_torch.launch import train as launcher
    wrappers = {"fused_xent": fused_xent, "flash_attention": flash_attention,
                "ssd_scan": ssd_intra_chunk}
    for w in wrappers.values():
        w.launches = 0
    res = launcher.main(train_args(model))
    launches = {k: w.launches for k, w in wrappers.items()}
    log, state = res["log"], res["state"]
    steps = res["steps"]
    cfg = zoo_config(model, "base")
    evals = steps + state.sub_iters
    expect = {k: n * evals for k, n in launches_per_eval(cfg).items()}
    emit("train" + SUFFIX[model], config=cfg.name, params=res["params"],
         params_active=cfg.param_count(active_only=True),
         steps=steps, losses=log.losses, accelerated=state.accel_count,
         sub_iters=state.sub_iters, branch_fired=bool(state.accel_count),
         ms_per_step=res["seconds"] / steps * 1e3,
         ms_per_step_after_first=(log.wall[-1] - log.wall[0]) / (steps - 1) * 1e3,
         seconds=res["seconds"], peak_mem_gib=res["peak_bytes"] / 2**30,
         launches=launches, expected_launches=expect)
    if not all(math.isfinite(x) for x in log.losses):
        raise SystemExit(f"non-finite training loss: {log.losses}")
    if abs(log.losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise SystemExit(f"step-1 loss {log.losses[0]} is not near "
                         f"ln({cfg.vocab_size}) = {math.log(cfg.vocab_size):.3f}")
    if launches != expect:
        raise SystemExit(f"kernel launches {launches} != expected {expect}")
    return {"launches": launches, "step1_loss": log.losses[0], "log": log,
            "per_eval": launches_per_eval(cfg), "peak_bytes": res["peak_bytes"],
            # the final params and velocity, for async_ps
            "final_sum": engine_checksum(res["model"].params(), state.base)}


def launches_per_eval(cfg) -> dict:
    """Kernel launches per loss-and-gradient evaluation under ``--kernels
    cuda``: ψ launches fused_xent once; under remat each GQA attention
    layer's flash_attention and each SSM layer's ssd_scan run twice (the
    forward and the backward's recomputation). MLA, cross attention and
    the encoder run no kernel, as in the JAX package."""
    from repro_torch.models.transformer import layer_specs
    mixers = [s.mixer for s in layer_specs(cfg)]
    return {"fused_xent": 1, "flash_attention": 2 * mixers.count("attn"),
            "ssd_scan": 2 * mixers.count("ssm")}


def phase_parity(model: str, train_step1: float):
    """Step 1's loss through the kernels and through the model's plain
    paths, from the same init on the same batch: within the bf16 tolerance
    of ``fused_xent`` and within PARITY_TIGHT. At init the loss sits near
    ln V whatever the mixers return, so the first layer's mixer output is
    also held, kernel against plain, at the path's shape (8 × 1024 tokens),
    within the bf16 tolerance of its kernel: ``ssd_scan`` on the SSM path,
    ``flash_attention`` (through ``gqa_flash``) on the attention paths."""
    from repro_torch.configs import zoo_config
    from repro_torch.data import FCPRSampler, make_lm_tokens
    from repro_torch.kernels.numerics import TOLERANCES
    from repro_torch.models import build_model
    from repro_torch.models.layers import attn_forward
    from repro_torch.models.ssm import ssm_forward
    cfg = zoo_config(model, "base")
    data = make_lm_tokens(0, 32, 1024, cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(
        FCPRSampler(data, batch_size=8, seed=1)(0)["tokens"]).cuda()}
    loss = {}
    for kernels in ("cuda", "reference"):
        m = build_model(cfg, kernels=kernels, param_dtype=torch.bfloat16,
                        device="cuda")
        m.init(0)
        with torch.no_grad():
            loss[kernels] = float(m.loss_fn(batch)[0])
            if kernels == "cuda":
                h = torch.from_numpy(np.random.RandomState(2).randn(
                    8, 1024, cfg.d_model).astype(np.float32)).cuda().to(torch.bfloat16)
                layer = m.module.layers[0]
                pos = torch.arange(1024, device="cuda")[None, :]
                if layer.spec.mixer == "ssm":
                    kernel, run = "ssd_scan", partial(ssm_forward, layer.mixer, cfg, h)
                else:
                    kernel, run = "flash_attention", partial(
                        attn_forward, layer.mixer, cfg, h, pos,
                        window=layer.spec.window)
                mixer = {"kernel": kernel, **compare(
                    run(use_kernel=True), run(use_kernel=False),
                    TOLERANCES[kernel]["bfloat16"])}
        del m
    rtol = TOLERANCES["fused_xent"]["bfloat16"][0]
    rel = abs(loss["cuda"] - loss["reference"]) / abs(loss["reference"])
    rel_train = abs(train_step1 - loss["cuda"]) / abs(loss["cuda"])
    emit("parity" + SUFFIX[model], loss_cuda=loss["cuda"], loss_reference=loss["reference"],
         rel=rel, train_step1=train_step1, rel_train=rel_train, rtol=rtol,
         rtol_tight=PARITY_TIGHT, mixer_layer0=mixer)
    if not (rel <= min(rtol, PARITY_TIGHT) and rel_train <= min(rtol, PARITY_TIGHT)):
        raise SystemExit("step-1 loss: kernels and plain paths disagree")
    if not mixer["ok"]:
        raise SystemExit(f"layer 0's mixer: kernel and plain disagree: {mixer}")


# the device kernels each wrapper launches (the first one once per call)
DEVICE_KERNELS = {"fused_xent": ("xent_partial", "xent_combine"),
                  "flash_attention": ("flash_fwd",),
                  "ssd_scan": ("ssd_chunk",)}


def phase_profile(model: str, main_checks: dict):
    """Device time by kernel over three training steps of a path (a fresh
    launcher run), from torch.profiler's CUDA events; the busy share is
    that time over the launcher's own step clock. Each of the port's
    kernels on the path also gets its mean device time per call, beside
    its isolated ``cuda_ms`` time at the main shape."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as launcher
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = launcher.main(train_args(model, steps=3))
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith(SPANS)),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    per_call = {}
    for name, keys in DEVICE_KERNELS.items():
        calls = sum(c for _, k, c in rows if keys[0] in k)
        if calls:
            total = sum(t for t, k, _ in rows if any(x in k for x in keys))
            per_call[name] = {"calls": calls, "device_ms_per_call": total / 1e3 / calls,
                              "isolated_ms": main_checks[name]["kernel_ms"]}
    emit("profile" + SUFFIX[model], steps=3, step_window_s=res["seconds"], device_busy_s=busy,
         busy_share=busy / res["seconds"], kernels=per_call,
         top=[{"name": k[:90], "ms_per_step": t / 1e3 / 3, "calls": c,
               "share": t / 1e6 / busy} for t, k, c in rows[:15]])



# ---------------------------------------------------------------------------
# the fused engine (CUDA graph, IF nodes) and the paper's CNN
# ---------------------------------------------------------------------------
# host spans that the profiler also projects onto the device timeline
SPANS = ("ProfilerStep", "obs/")


def device_rows(prof) -> list:
    """(self device µs, name, calls) of every CUDA event, largest first,
    without the spans on the device timeline (the profiler's own
    ``ProfilerStep#`` and the port's ``obs/*``), which would count their
    kernels twice."""
    return sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith(SPANS)),
                  reverse=True)


def ms_after(log, first: int) -> float:
    """ms per step after the first ``first`` steps, by the log's walls."""
    return ms_after_walls(log.wall, first)


def ms_after_walls(wall: list, first: int) -> float:
    """``ms_after`` of a list of walls."""
    n = len(wall) - first
    return (wall[-1] - wall[first - 1]) / n * 1e3


def report_chunked(name: str, res: dict, ref_log, k: int, **extra) -> dict:
    """The fused run against the per-step run of the same path: identical
    accelerate and sub_iters sequences and every loss equal, bit for bit;
    ms/step of both after the first chunk."""
    log = res["log"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(log.losses, ref_log.losses))
    same = (log.accelerated == ref_log.accelerated[:len(log.accelerated)]
            and log.sub_iters == ref_log.sub_iters[:len(log.sub_iters)])
    out = dict(chunk_steps=k, steps=res["steps"], losses=log.losses,
               accelerated=log.accelerated, sub_iters=log.sub_iters,
               same_decisions=same, max_rel_loss_diff=rel,
               bit_exact=log.losses == ref_log.losses[:len(log.losses)],
               ms_per_step_after_first_chunk=ms_after(log, k),
               per_step_ms_after_first_chunk=ms_after(ref_log, k),
               capture_seconds=res["capture_seconds"],
               peak_mem_gib=res["peak_bytes"] / 2**30,
               peak_reserved_gib=res["peak_reserved"] / 2**30, **extra)
    emit(name, **out)
    if len(log.losses) != len(ref_log.losses) or not same:
        raise SystemExit(f"{name}: the fused run's decisions differ from the "
                         f"per-step run's")
    if not out["bit_exact"]:
        raise SystemExit(f"{name}: the fused losses differ from the per-step "
                         f"run's by up to {rel:.3g} relative")
    return out


def phase_chunked(model: str, per_step: dict, k: int = CHUNK):
    from repro_torch.launch import train as launcher
    args = launcher.parse_args(train_args(model) + ["--chunk-steps", str(k)])
    res = launcher.run(args, fused=True)
    out = report_chunked("chunked" + SUFFIX[model] + ("" if k == CHUNK else f"_k{k}"),
                         res, per_step["log"], k, config=zoo_base(model).name)
    if model == "transformer" and not sum(out["sub_iters"]):
        raise SystemExit("no Alg. 2 trip ran inside the graph")
    return dict(out, log=res["log"])


def zoo_base(model: str):
    from repro_torch.configs import zoo_config as zc
    return zc(model, "base")


def chunk_profiler(cycles: int):
    """(profiler, rows): a torch.profiler that records each chunk as a
    cycle of its own (the chunk loops step it after each chunk) and appends
    that cycle's ``device_rows`` to ``rows``. One window over three chunks
    of a zoo path holds about 80,000 device events, and CUPTI then drops
    records (433 of 448 ``flash_fwd`` in one such window on an H100); with
    one chunk, about 27,000, a cycle it drops fewer, but not always none."""
    from torch.profiler import ProfilerActivity, profile, schedule
    rows = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=0, active=1, repeat=cycles),
                   on_trace_ready=lambda p: rows.append(device_rows(p)))
    return prof, rows


def profile_window(name: str, res: dict, cycles: list, launches: dict,
                   expect: dict, wall_s: float, ms_per_step: float):
    """Device time over the profiled chunks, and the port's launches in
    them: ``launches``, the wrappers' device counts (``launch_count``),
    must equal ``expect``; the profiler's count of each wrapper's first
    device kernel is printed beside them. The profiler is no count to hold
    a run to: CUPTI drops records of a graph's kernels now and then (439 of
    448 ``flash_fwd`` in one run of these three chunks on an H100, 448 in
    others). The busy share is the device time over ``wall_s``, the host
    time of the profiled chunks themselves (the profiler's own work between
    chunks left out); ``ms_per_step``, the wall time a step of the same run
    unprofiled, is printed beside it."""
    merged = {}
    for rows in cycles:
        for t, key, c in rows:
            tt, cc = merged.get(key, (0.0, 0))
            merged[key] = (tt + t, cc + c)
    rows = sorted(((t, key, c) for key, (t, c) in merged.items()), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    seen = {n: sum(c for _, key, c in rows if keys[0] in key)
            for n, keys in DEVICE_KERNELS.items()}
    steps = res["steps"]
    emit(name, steps=steps, chunk_steps=res["chunk_steps"], cycles=len(cycles),
         sub_iters=int(res["state"].sub_iters), device_busy_s=busy,
         profiled_chunks_s=wall_s, busy_share=busy / wall_s,
         device_ms_per_step=busy / steps * 1e3,
         unprofiled_ms_per_step=ms_per_step, launches=launches,
         expected_launches=expect, profiler_launches=seen,
         profiler_missing={n: expect[n] - seen[n] for n in expect},
         top=[{"name": key[:90], "ms_per_step": t / 1e3 / steps, "calls": c,
               "share": t / 1e6 / busy} for t, key, c in rows[:12]])
    if len(cycles) != steps // res["chunk_steps"]:
        raise SystemExit(f"{name}: {len(cycles)} profiled chunks of "
                         f"{steps // res['chunk_steps']}")
    if launches != expect:
        raise SystemExit(f"{name}: device launches {launches} != expected {expect}")


def phase_profile_chunked(path: str, per_eval: dict, ms_per_step: float):
    """Three chunks of the fused engine under torch.profiler, one profiler
    cycle a chunk, in a process of its own (this script with
    ``--profile-chunked``): in a process that had run an earlier profiler
    session and other graphs, CUPTI reported one or two ``flash_fwd``
    executions more than the graphs launch (per-chunk counts of 161 and
    162 where the captured graph holds 160; the same run in a fresh
    process reports 160)."""
    subprocess.run([sys.executable, os.path.abspath(__file__), "--profile-chunked",
                    path, json.dumps({"per_eval": per_eval, "ms_per_step": ms_per_step})],
                   check=True)


class ZeroedProfiler:
    """``prof`` (a profiler, or a ``nullcontext``), entered after zeroing
    the device launch counts: the launcher enters its profiler after the
    warm-up and the capture, just before the first chunk."""

    def __init__(self, prof):
        self.prof, self.step = prof, getattr(prof, "step", None)

    def __enter__(self):
        from repro_torch.kernels import launch_count
        launch_count.reset()
        return self.prof.__enter__()

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)


def device_counted(run, prof=None) -> tuple:
    """``run(profiler)``, a fused run, with the wrappers counting their
    launches on the device (``launch_count``: enabled before the capture,
    zeroed after it by ``ZeroedProfiler`` around ``prof``) -> (run's
    result, the counts of its timed chunks)."""
    from repro_torch.kernels import launch_count
    launch_count.enable("cuda", DEVICE_KERNELS)
    try:
        res = run(ZeroedProfiler(prof if prof is not None
                                 else contextlib.nullcontext()))
        return res, launch_count.read()
    finally:
        launch_count.disable()


def profile_chunked_child(path: str, spec: dict):
    """The profiled run of ``phase_profile_chunked``. The wrappers count
    their launches on the device (``launch_count``, enabled before the
    capture, zeroed after it). A kernel inside an IF node that did not fire
    does not run, so each wrapper's kernel runs evaluations ×
    per-evaluation times (the CNN runs none of them)."""
    prof, cycles = chunk_profiler(3)
    stepped = []                   # seconds in the profiler's own step()
    step = prof.step

    def timed_step():
        t0 = time.perf_counter()
        step()
        stepped.append(time.perf_counter() - t0)

    prof.step = timed_step
    if path == "cnn":
        res, launches = device_counted(
            lambda p: run_cnn_chunked(steps=3 * CHUNK, profiler=p), prof)
        name = "profile_chunked_cnn"
    else:
        from repro_torch.launch import train as launcher
        args = launcher.parse_args(train_args(path, steps=3 * CHUNK)
                                   + ["--chunk-steps", str(CHUNK)])
        res, launches = device_counted(
            lambda p: launcher.run(args, fused=True, profiler=p), prof)
        name = "profile_chunked" + SUFFIX[path]
    evals = res["steps"] + int(res["state"].sub_iters)
    profile_window(name, res, cycles, launches,
                   {n: spec["per_eval"][n] * evals for n in DEVICE_KERNELS},
                   res["seconds"] - sum(stepped), spec["ms_per_step"])


CNN_BATCH, CNN_STEPS, CNN_LR = 256, 24, 0.01


def cnn_setup():
    """``alexnet-small`` at its published width on 2048 images of
    ``make_classification(0, 2048, 64, 3, 1000, noise=0.5,
    difficulty=2.0)`` (8 FCPR batches of 256, 100.7 MB), random init, f32
    without TF32. cuDNN runs its deterministic algorithms: with the default
    ones two per-step runs of the same 24 steps differ by about 6e-5
    relative at the last step, so the two engines could not be held to
    each other bit for bit."""
    from repro_torch.configs import ALEXNET_SMALL
    from repro_torch.core import ISGDConfig
    from repro_torch.data import FCPRSampler, make_classification
    from repro_torch.models import CNN, cnn_loss_fn, init_cnn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    data = make_classification(0, 2048, 64, 3, 1000, noise=0.5, difficulty=2.0)
    sampler = FCPRSampler(data, batch_size=CNN_BATCH, seed=1)
    module = init_cnn(CNN(ALEXNET_SMALL, device="cuda"), seed=0)
    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=1.0, stop=3)
    return module, (lambda b: cnn_loss_fn(module, b)), sampler, icfg


def phase_train_cnn() -> dict:
    from repro_torch.core import constant_lr
    from repro_torch.models.cnn import l2_sum
    from repro_torch.optim import momentum
    from repro_torch.train import train
    module, loss_fn, sampler, icfg = cnn_setup()
    params = list(module.parameters())
    with torch.no_grad():
        l2 = float(0.5 * 1e-4 * l2_sum(module))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, log, _ = train(params, loss_fn, momentum(0.9), sampler,
                                  steps=CNN_STEPS, isgd_cfg=icfg,
                                  lr_fn=constant_lr(CNN_LR))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    expect1 = math.log(module.cfg.num_classes) + l2
    emit("train_cnn", config=module.cfg.name, params=sum(p.numel() for p in params),
         batch=CNN_BATCH, steps=CNN_STEPS, losses=log.losses,
         accelerated=state.accel_count, sub_iters=state.sub_iters,
         ms_per_step=dt / CNN_STEPS * 1e3, ms_per_step_after_first=ms_after(log, 1),
         ms_per_step_after_first_chunk=ms_after(log, CHUNK),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         step1_loss=log.losses[0], step1_expected=expect1, l2_term=l2)
    if not all(math.isfinite(x) for x in log.losses):
        raise SystemExit(f"non-finite CNN loss: {log.losses}")
    if abs(log.losses[0] - expect1) > 1.0:
        raise SystemExit(f"CNN step-1 loss {log.losses[0]} is not near "
                         f"ln 1000 + L2 = {expect1:.3f}")
    return {"log": log}


def run_cnn_chunked(steps: int = CNN_STEPS, profiler=None) -> dict:
    """The CNN through ``make_chunked_train_step`` over a ``DeviceRing``;
    warm-up and capture before the clock, ``profiler`` around the steps."""

    from repro_torch.core import constant_lr
    from repro_torch.data import DeviceRing
    from repro_torch.launch.train import _drive_chunks
    from repro_torch.optim import momentum
    from repro_torch.train import make_chunked_train_step
    module, loss_fn, sampler, icfg = cnn_setup()
    ring = DeviceRing(sampler.epoch_arrays(), CNN_BATCH)
    init_fn, chunk = make_chunked_train_step(loss_fn, momentum(0.9), icfg,
                                             chunk_steps=CHUNK,
                                             lr_fn=constant_lr(CNN_LR))
    params = list(module.parameters())
    state = init_fn(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk.prepare(state, params, ring.arrays)
    with profiler if profiler is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        (state, params), steps, log, _ = _drive_chunks(
            chunk, (state, params), ring, steps, CHUNK, t0,
            on_chunk=getattr(profiler, "step", None))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return {"log": log, "state": state, "seconds": dt, "steps": steps,
            "chunk_steps": CHUNK, "capture_seconds": chunk.capture_seconds,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved": torch.cuda.max_memory_reserved()}


def phase_chunked_cnn(per_step: dict) -> float:
    out = report_chunked("chunked_cnn", run_cnn_chunked(), per_step["log"],
                         CHUNK, config="alexnet-small")
    return out["ms_per_step_after_first_chunk"]



# ---------------------------------------------------------------------------
# telemetry, micro-batches, profiler traces, and evaluation
# ---------------------------------------------------------------------------
OBS_STEPS = 8                              # two fused chunks; step 8 accelerates


def phase_obs():
    """The transformer path through the launcher, 8 steps per-step and 8
    fused (K = 4), each engine run twice in turn: without ``--obs-dir``,
    then with it (a temporary directory). The observed run's ``spc.final``
    must reconcile with its engine's queue bit for bit, its JSONL must pass
    the port's validator, and its losses, accelerate flags and sub_iters
    must equal the unobserved run's bit for bit: observing changes nothing.
    ms/step of both runs is printed (after step 1, or after the first
    chunk), with ``train/dispatches``."""
    import tempfile

    from repro_torch.launch import train as launcher
    from repro_torch.obs import read_jsonl, validate
    for engine, first in (("per-step", 1), ("chunked", CHUNK)):
        t0 = time.perf_counter()
        extra = [] if engine == "per-step" else ["--chunk-steps", str(CHUNK)]
        ref = launcher.main(train_args("transformer", OBS_STEPS) + extra)["log"]
        with tempfile.TemporaryDirectory() as d:
            res = launcher.main(train_args("transformer", OBS_STEPS) + extra
                                + ["--obs-dir", d])
            valid = validate.main([d]) == 0
            records = read_jsonl(os.path.join(d, "metrics.p0.jsonl"))
        log, final = res["log"], res["obs"]
        same = (log.losses == ref.losses and log.accelerated == ref.accelerated
                and log.sub_iters == ref.sub_iters)
        emit("obs", engine=engine, steps=len(log.losses),
             reconciled=final["reconciled"], mismatches=final["mismatches"],
             jsonl_valid=valid, records=len(records),
             accel_events=final["accel_events"], sub_iters=final["sub_iters"],
             dispatches=final.get("throughput", {}).get("dispatches", 0),
             identical_to_run_without_obs=same, losses=log.losses,
             ms_per_step_with_obs=ms_after(log, first),
             ms_per_step_without_obs=ms_after(ref, first), after_steps=first,
             peak_mem_gib=res["peak_bytes"] / 2**30,
             seconds=time.perf_counter() - t0)
        if not (final["reconciled"] and valid and same):
            raise SystemExit(f"obs ({engine}): reconciled={final['reconciled']} "
                             f"{final['mismatches']} valid={valid} "
                             f"identical={same}")


def transformer_parts():
    """The launcher's transformer set-up (``train_args``), through the
    library: (model, sampler, ISGDConfig, rule, lr_fn)."""
    from repro_torch.core import ISGDConfig, constant_lr
    from repro_torch.data import FCPRSampler, make_lm_tokens
    from repro_torch.models import build_model
    from repro_torch.optim import momentum
    cfg = zoo_base("transformer")
    m = build_model(cfg, kernels="cuda", param_dtype=torch.bfloat16,
                    device="cuda")
    m.init(0)
    sampler = FCPRSampler(make_lm_tokens(0, 32, 1024, cfg.vocab_size),
                          batch_size=8, seed=1)
    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=1.0, stop=3)
    return m, sampler, icfg, momentum(0.9), constant_lr(0.05)


MICRO = 2                                  # micro-batches of the phase below


def phase_micro_batches():
    """``micro_batches=2`` on the transformer path (batch 8 as two of 4):
    8 steps through the per-step engine (``make_step_core``) and through
    the fused engine (K = 4), whose graph captures the micro-batch loop and
    its f32 gradient sums, in the Alg. 2 bodies too. The fused run must
    equal the per-step run bit for bit (losses, flags, sub_iters). Capture
    time and peak memory (allocated and reserved) are printed; the fused
    m = 1 run of the ``chunked`` phase is the comparison."""
    from repro_torch.data import DeviceRing
    from repro_torch.train import (TrainLog, host_metrics,
                                   make_chunked_train_step, make_step_core)
    logs, peaks = {}, {}
    capture = None
    start = time.perf_counter()
    for engine in ("per-step", "fused"):
        m, sampler, icfg, rule, lr_fn = transformer_parts()
        params = m.params()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        log = TrainLog()
        if engine == "per-step":
            init_fn, step = make_step_core(m.loss_fn, rule, icfg, lr_fn=lr_fn,
                                           micro_batches=MICRO)
            state = init_fn(params)
            for j in range(OBS_STEPS):
                batch = {k: torch.from_numpy(v).cuda()
                         for k, v in sampler(j).items()}
                state, params, ms = step(state, params, batch)
                log.append(ms, 0.0)
        else:
            ring = DeviceRing(sampler.epoch_arrays(), 8)
            init_fn, chunk = make_chunked_train_step(
                m.loss_fn, rule, icfg, chunk_steps=CHUNK, lr_fn=lr_fn,
                micro_batches=MICRO)
            state = init_fn(params)
            chunk.prepare(state, params, ring.arrays)
            capture = chunk.capture_seconds
            t0 = time.perf_counter()
            for c in range(OBS_STEPS // CHUNK):
                state, params, ms = chunk(state, params, ring.arrays, c * CHUNK)
                host = host_metrics(ms)          # waits for the chunk
                log.extend(host, time.perf_counter() - t0)
        torch.cuda.synchronize()
        logs[engine] = log
        peaks[engine] = (torch.cuda.max_memory_allocated() / 2**30,
                         torch.cuda.max_memory_reserved() / 2**30)
        del m, params, state
    ref, got = logs["per-step"], logs["fused"]
    same = (got.losses == ref.losses and got.accelerated == ref.accelerated
            and got.sub_iters == ref.sub_iters)
    emit("micro_batches", config=zoo_base("transformer").name,
         micro_batches=MICRO, chunk_steps=CHUNK, steps=OBS_STEPS,
         losses=got.losses, accelerated=got.accelerated,
         sub_iters=got.sub_iters, bit_exact_with_per_step=same,
         capture_seconds=capture,
         fused_ms_per_step_after_first_chunk=ms_after(got, CHUNK),
         peak_mem_gib={k: v[0] for k, v in peaks.items()},
         peak_reserved_gib={k: v[1] for k, v in peaks.items()},
         seconds=time.perf_counter() - start)
    if not same:
        raise SystemExit("micro_batches: the fused run differs from the "
                         "per-step run")
    if not all(math.isfinite(x) for x in got.losses):
        raise SystemExit(f"micro_batches: non-finite loss {got.losses}")


PROFILE_SPANS = ("obs/psi_push", "obs/accelerate", "obs/chunk_scan")
PROFILE_KERNELS = ("xent_partial", "flash_fwd")   # within demangled names


def phase_profile_dir():
    """3 steps of the transformer path through the launcher with
    ``--profile-dir``, per-step and through the fused engine with K = 1 (3
    chunks): each run writes a trace, and across the two traces the names
    of the path's kernels (``xent_partial``, ``flash_fwd``) and the three
    ``obs/*`` spans appear (``obs/chunk_scan`` wraps a chunk's replays;
    ``obs/psi_push`` and ``obs/accelerate`` run on the host in the
    per-step engine, and in the fused engine only at its capture, which is
    before the trace). No launch is counted from a trace: CUPTI drops
    records of a graph's kernels."""
    import glob
    import tempfile

    from repro_torch.launch import train as launcher
    found = {}
    for engine in ("per-step", "chunked"):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            args = launcher.parse_args(train_args("transformer", steps=3)
                                       + ["--chunk-steps", "1",
                                          "--profile-dir", d])
            launcher.run(args, fused=engine == "chunked")
            traces = glob.glob(os.path.join(d, "*.json"))
            if len(traces) != 1:
                raise SystemExit(f"profile_dir ({engine}): traces {traces}")
            size = os.path.getsize(traces[0])
            with open(traces[0]) as fh:
                events = json.load(fh)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        every = {e.get("name") for e in events}
        names = {n: n in every for n in PROFILE_SPANS}
        names.update({k: any(k in name for name in kernels)
                      for k in PROFILE_KERNELS})
        found[engine] = names
        emit("profile_dir", engine=engine, trace_bytes=size,
             kernel_events=sum(e.get("cat") == "kernel" for e in events),
             names=names, seconds=time.perf_counter() - t0)
    missing = [n for n in found["per-step"]
               if not any(f[n] for f in found.values())]
    if missing:
        raise SystemExit(f"profile_dir: {missing} in no trace")


EVAL_SEED, EVAL_EPOCHS, EVAL_LR, EVAL_BATCH = 100, 5, 0.01, 100


def eval_cnn_setup():
    """``cifar-quick`` at its published width (32 × 32 × 3, 10 classes) on
    ``make_classification(100, 10000, 32, 3, 10, noise=0.5,
    class_skew=0.2, class_spread=0.5)`` (100 FCPR batches of 100,
    shuffle_quality 0.5, as ``benchmarks/table1_time_to_accuracy.py``
    draws it), 2000 held-out images of seed 877; momentum 0.9, k_sigma 1.5,
    stop 3, ζ 0.02, f32 without TF32, cuDNN deterministic."""
    from repro_torch.core import ISGDConfig
    from repro_torch.data import FCPRSampler, make_classification
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    data = make_classification(EVAL_SEED, 100 * EVAL_BATCH, 32, 3, 10,
                               noise=0.5, class_skew=0.2, class_spread=0.5)
    test = make_classification(EVAL_SEED + 777, 2000, 32, 3, 10, noise=0.5)
    sampler = FCPRSampler(data, batch_size=EVAL_BATCH, seed=EVAL_SEED,
                          shuffle_quality=0.5)
    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=1.5, stop=3,
                      zeta=0.02)
    return sampler, icfg, {k: torch.from_numpy(v).cuda() for k, v in test.items()}


def phase_eval_cnn():
    """Time to accuracy of ISGD against consistent SGD on ``cifar-quick``
    from one init (seed 0): per-step with ``eval_fn=cnn_accuracy`` every
    epoch and ``step_sync=True``, then the ISGD leg again through the fused
    engine (K = 4), evaluated at each epoch's end. Gates: every per-step
    wall is measured (``require_measured_walls``), each leg ends
    at 2× chance or better, ISGD accelerates at least twice, and the fused
    leg's losses, flags and sub_iters equal the per-step ISGD leg's bit for
    bit (its Alg. 2 trips run in IF nodes whose bodies hold cuDNN
    convolutions). Time to accuracy (the first eval wall at the lower of
    the per-step legs' final accuracies) is reported, not gated."""
    from repro_torch.configs import CIFAR_QUICK
    from repro_torch.core import constant_lr
    from repro_torch.data import DeviceRing
    from repro_torch.models import CNN, cnn_accuracy, cnn_loss_fn, init_cnn
    from repro_torch.obs import require_measured_walls
    from repro_torch.optim import momentum
    from repro_torch.train import (TrainLog, host_metrics,
                                   make_chunked_train_step, train)
    sampler, icfg, test = eval_cnn_setup()
    steps = EVAL_EPOCHS * sampler.n_batches
    legs = {}
    for leg in ("isgd", "sgd", "isgd_fused"):
        start = time.perf_counter()
        module = init_cnn(CNN(CIFAR_QUICK, device="cuda"), seed=0)
        params = list(module.parameters())

        def loss_fn(b, module=module):
            return cnn_loss_fn(module, b)

        def eval_fn(_, module=module):
            return cnn_accuracy(module, test["images"], test["labels"])

        torch.cuda.synchronize()
        if leg != "isgd_fused":
            _, state, log, evals = train(
                params, loss_fn, momentum(0.9), sampler, steps=steps,
                lr=EVAL_LR, inconsistent=leg == "isgd", isgd_cfg=icfg,
                eval_fn=eval_fn, eval_every=sampler.n_batches,
                step_sync=True)
            require_measured_walls(log.wall_est, context=f"eval_cnn {leg}")
            capture = None
        else:
            ring = DeviceRing(sampler.epoch_arrays(), EVAL_BATCH)
            init_fn, chunk = make_chunked_train_step(
                loss_fn, momentum(0.9), icfg, chunk_steps=CHUNK,
                lr_fn=constant_lr(EVAL_LR))
            state = init_fn(params)
            chunk.prepare(state, params, ring.arrays)
            capture = chunk.capture_seconds
            log, evals = TrainLog(), []
            t0 = time.perf_counter()
            for j in range(0, steps, CHUNK):
                state, params, ms = chunk(state, params, ring.arrays, j)
                host = host_metrics(ms)          # waits for the chunk
                log.extend(host, time.perf_counter() - t0)
                if (j + CHUNK) % sampler.n_batches == 0:
                    evals.append((j + CHUNK, time.perf_counter() - t0,
                                  eval_fn(params)))
        legs[leg] = {"log": log, "evals": evals,
                     "accelerated": int(state.accel_count),
                     "sub_iters": int(state.sub_iters), "capture": capture,
                     "seconds": time.perf_counter() - start}
    target = min(legs[k]["evals"][-1][2] for k in ("isgd", "sgd"))
    for leg, r in legs.items():
        log = r["log"]
        first = CHUNK if leg == "isgd_fused" else 1
        hit = [w for _, w, acc in r["evals"] if acc >= target]
        emit("eval_cnn", leg=leg, config="cifar-quick", batch=EVAL_BATCH,
             lr=EVAL_LR, steps=len(log.losses),
             evals=[{"step": s, "wall_s": w, "accuracy": a,
                     "wall_est": log.wall_est[s - 1]} for s, w, a in r["evals"]],
             accelerated=r["accelerated"], sub_iters=r["sub_iters"],
             accelerate_steps=[i + 1 for i, a in enumerate(log.accelerated) if a],
             target_accuracy=target, time_to_target_s=hit[0] if hit else None,
             ms_per_step=ms_after(log, first), after_steps=first,
             capture_seconds=r["capture"], final_loss=log.losses[-1],
             seconds=r["seconds"])
        if not all(math.isfinite(x) for x in log.losses):
            raise SystemExit(f"eval_cnn {leg}: non-finite loss")
        if r["evals"][-1][2] < 0.2:
            raise SystemExit(f"eval_cnn {leg}: accuracy {r['evals'][-1][2]} "
                             f"is below 2x chance")
    isgd, fused = legs["isgd"]["log"], legs["isgd_fused"]["log"]
    if legs["isgd"]["accelerated"] < 2:
        raise SystemExit(f"eval_cnn: ISGD accelerated "
                         f"{legs['isgd']['accelerated']} times, fewer than 2")
    if not (fused.losses == isgd.losses and fused.accelerated == isgd.accelerated
            and fused.sub_iters == isgd.sub_iters):
        raise SystemExit("eval_cnn: the fused ISGD leg differs from the "
                         "per-step leg")


# ---------------------------------------------------------------------------
# the ten assigned architectures, reduced
# ---------------------------------------------------------------------------
# step-1 loss of a reduced config, kernels against plain paths, relative, in
# bf16: a kernel's rounding can flip a near-tie of an MoE router's top-k at
# init and send a token to another expert (reduced Mixtral: 8.8e-4 on an
# NVIDIA H100 80GB HBM3 at 700 W; the configs without MoE within 3e-4)
ARCH_PARITY = 2e-3
ARCH_STEPS, CHUNK_ARCH_STEPS = 3, 8
CHUNKED_ARCHS = ("deepseek_v2_lite_16b", "jamba_v0_1_52b")


def arch_args(arch: str, steps: int) -> list:
    """A reduced architecture through the launcher: bf16, batch 2 × 64."""
    return ["--arch", arch, "--reduced", "--kernels", "cuda", "--precision",
            "bf16", "--batch", "2", "--seq", "64", "--n-seqs", "8",
            "--steps", str(steps), "--k-sigma", "1.0", "--stop", "3",
            "--device", "cuda"]


def arch_step1_loss(cfg, kernels: str) -> float:
    """Step 1's total loss of the launcher's run (init seed 0, FCPR batch
    0 of ``make_lm_tokens(0, 8, 64, V)``, zero bf16 frontend embeddings)
    through ``kernels``, without a gradient."""
    from repro_torch.data import FCPRSampler, make_lm_tokens
    from repro_torch.launch.train import frontend_embeds
    from repro_torch.models import build_model
    data = make_lm_tokens(0, 8, 64, cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(
        FCPRSampler(data, batch_size=2, seed=1)(0)["tokens"]).cuda(),
        **frontend_embeds(cfg, 2, "cuda")}
    m = build_model(cfg, kernels=kernels, param_dtype=torch.bfloat16,
                    device="cuda")
    m.init(0)
    with torch.no_grad():
        return float(m.loss_fn(batch)[0])


def phase_arch_reduced():
    """Every ``ARCH_IDS`` entry's ``reduced()`` config, 3 per-step steps
    through the launcher with ``--kernels cuda`` in bf16. Each run must
    launch exactly its plan's kernels (``launches_per_eval``: flash_attention
    on every GQA attention layer, none on MLA, cross attention or the
    encoder; ssd_scan on every SSM layer; fused_xent once an evaluation),
    and its step-1 loss must agree, within ARCH_PARITY relative, with the
    same init and batch through the kernels without a gradient and through
    ``--kernels reference``."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_xent import fused_xent
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk
    from repro_torch.launch import train as launcher
    wrappers = {"fused_xent": fused_xent, "flash_attention": flash_attention,
                "ssd_scan": ssd_intra_chunk}
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        for w in wrappers.values():
            w.launches = 0
        res = launcher.main(arch_args(arch, ARCH_STEPS))
        launches = {k: w.launches for k, w in wrappers.items()}
        log, state = res["log"], res["state"]
        evals = res["steps"] + int(state.sub_iters)
        expect = {k: n * evals for k, n in launches_per_eval(cfg).items()}
        loss = {k: arch_step1_loss(cfg, k) for k in ("cuda", "reference")}
        rel = abs(loss["cuda"] - loss["reference"]) / abs(loss["reference"])
        rel_train = abs(log.losses[0] - loss["cuda"]) / abs(loss["cuda"])
        emit("arch_reduced", arch=arch, config=cfg.name, family=cfg.family,
             params=res["params"], steps=res["steps"], losses=log.losses,
             sub_iters=int(state.sub_iters), launches=launches,
             expected_launches=expect, loss_cuda=loss["cuda"],
             loss_reference=loss["reference"], rel=rel, rel_train=rel_train,
             rtol=ARCH_PARITY, ms_per_step=res["seconds"] / res["steps"] * 1e3,
             seconds=time.perf_counter() - t0)
        if not all(math.isfinite(x) for x in log.losses):
            raise SystemExit(f"arch_reduced {arch}: non-finite loss {log.losses}")
        if launches != expect:
            raise SystemExit(f"arch_reduced {arch}: launches {launches} != "
                             f"expected {expect}")
        if not (rel <= ARCH_PARITY and rel_train <= ARCH_PARITY):
            raise SystemExit(f"arch_reduced {arch}: step-1 loss, kernels and "
                             f"plain paths disagree ({rel:.3g}, {rel_train:.3g})")


def phase_chunked_arch():
    """Two reduced configs through the fused engine (K = 4, 8 steps)
    against the per-step engine (8 steps), bit for bit: DeepSeek-V2-Lite
    (a dense prefix layer, MLA, shared experts) and Jamba (seven SSM layers
    and one attention layer, MoE every second layer), so that MoE routing,
    MLA and ssd_scan run inside the captured graph. The fused run's
    launches are counted on the device (``launch_count``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    for arch in CHUNKED_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        ref = launcher.main(arch_args(arch, CHUNK_ARCH_STEPS))
        args = launcher.parse_args(arch_args(arch, CHUNK_ARCH_STEPS)
                                   + ["--chunk-steps", str(CHUNK)])
        res, launches = device_counted(
            lambda p: launcher.run(args, fused=True, profiler=p))
        evals = res["steps"] + int(res["state"].sub_iters)
        expect = {k: n * evals for k, n in launches_per_eval(cfg).items()}
        report_chunked("chunked_arch", res, ref["log"], CHUNK, arch=arch, config=cfg.name, launches=launches,
                       expected_launches=expect,
                       seconds=time.perf_counter() - t0)
        if launches != expect:
            raise SystemExit(f"chunked_arch {arch}: device launches "
                             f"{launches} != expected {expect}")


# ---------------------------------------------------------------------------
# batch schedules and checkpoints
# ---------------------------------------------------------------------------
SCHED_STEPS = 12
RESUME_KILL, RESUME_K0, RESUME_K1 = 6, 3, 4  # kill at a K=3 boundary, resume K=4
RESUME_STEPS = 14                          # 6 + two chunks of 4: mid-chunk resume
# paper-transformer's unscheduled ms/step as recorded before schedules were
# added (PERF.md; NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
RECORDED_MS = {"per-step": 299.27, "fused": 287.87}
LOG_KEYS = ("losses", "accelerated", "sub_iters", "batch_idx")


def sequences(res: dict, start: int = 0, n: int = None) -> dict:
    """A launcher run's per-step sequences (``LOG_KEYS``), steps
    ``start..start+n-1`` of its log."""
    log = res["log"]
    out = {k: getattr(log, k) for k in LOG_KEYS[:3]}
    out["batch_idx"] = res["batch_idx"]
    end = None if n is None else start + n
    return {k: v[start:end] for k, v in out.items()}


def phase_sched(per_step: dict, chunked: dict):
    """Batch schedules on the transformer path (``--schedule``), through
    the launcher: ``fcpr`` through the fused engine (K = 4, 12 steps) must
    equal the unscheduled fused run of ``chunked`` bit for bit (losses,
    accelerate and sub_iters sequences); ``loss-prop`` per-step (14 steps:
    the resume phase's reference) and fused (K = 4, 12 steps) must agree bit
    for bit on their 12 common steps, batch picks included, sweep 0..n_b−1
    first and visit every batch. The fused ``loss-prop`` run's launches are
    counted on the device: selection, table update and gather sit in its
    graph, so they must be exactly the unscheduled path's per evaluation.
    -> the per-step ``loss-prop`` run's result."""
    from repro_torch.launch import train as launcher
    t0 = time.perf_counter()
    fused_args = ["--chunk-steps", str(CHUNK)]
    fcpr = launcher.run(launcher.parse_args(
        train_args("transformer", SCHED_STEPS) + ["--schedule", "fcpr"]
        + fused_args), fused=True)
    fcpr_same = (fcpr["log"].losses == chunked["losses"]
                 and fcpr["log"].accelerated == chunked["accelerated"]
                 and fcpr["log"].sub_iters == chunked["sub_iters"])
    lp = ["--schedule", "loss-prop"]
    ref = launcher.main(train_args("transformer", RESUME_STEPS) + lp)
    args = launcher.parse_args(train_args("transformer", SCHED_STEPS) + lp
                               + fused_args)
    fused, launches = device_counted(
        lambda p: launcher.run(args, fused=True, profiler=p))
    log, ref_log = fused["log"], ref["log"]
    picks = fused["batch_idx"]
    n_b = 32 // 8
    evals = fused["steps"] + int(fused["state"].sub_iters)
    expect = {k: n * evals for k, n in
              launches_per_eval(zoo_base("transformer")).items()}
    out = dict(config=zoo_base("transformer").name, steps=SCHED_STEPS,
               chunk_steps=CHUNK, fcpr_equals_unscheduled=fcpr_same,
               fcpr_losses=fcpr["log"].losses,
               loss_prop_per_step_equals_fused=(
                   sequences(fused) == sequences(ref, 0, SCHED_STEPS)),
               batch_idx=picks, losses=log.losses,
               accelerated=log.accelerated, sub_iters=log.sub_iters,
               visits=np.bincount(picks, minlength=n_b).tolist(),
               launches=launches, expected_launches=expect,
               ms_per_step={
                   "fcpr_fused": ms_after(fcpr["log"], CHUNK),
                   "loss_prop_fused": ms_after(log, CHUNK),
                   "loss_prop_per_step": ms_after(ref_log, 1),
                   "unscheduled_per_step": ms_after(per_step["log"], 1),
                   "unscheduled_fused": chunked["ms_per_step_after_first_chunk"],
                   "recorded_unscheduled": RECORDED_MS},
               # the runs differ in Alg. 2 trips: ms per evaluation (a step
               # or a trip) over the same steps sets them side by side
               ms_per_eval={
                   "fcpr_fused": ms_per_eval(fcpr["log"], CHUNK),
                   "loss_prop_fused": ms_per_eval(log, CHUNK),
                   "loss_prop_per_step": ms_per_eval(ref_log, 1),
                   "unscheduled_per_step": ms_per_eval(per_step["log"], 1)},
               capture_seconds=fused["capture_seconds"],
               seconds=time.perf_counter() - t0)
    emit("sched", **out)
    if not fcpr_same:
        raise SystemExit("sched: fcpr through the fused engine differs from "
                         "the unscheduled fused run")
    if not out["loss_prop_per_step_equals_fused"]:
        raise SystemExit("sched: loss-prop per-step and fused differ")
    if picks[:n_b] != list(range(n_b)) or min(out["visits"]) == 0:
        raise SystemExit(f"sched: warm-up sweep or visits wrong: {picks}")
    if launches != expect:
        raise SystemExit(f"sched: device launches {launches} != expected "
                         f"{expect}")
    return ref


def ms_per_eval(log, first: int) -> float:
    """ms per loss-and-gradient evaluation after the first ``first`` steps,
    by the log's walls (each step one, each Alg. 2 trip one more)."""
    evals = len(log.wall) - first + sum(log.sub_iters[first:])
    return (log.wall[-1] - log.wall[first - 1]) / evals * 1e3


def child_cmd(out: str, spec: dict, argv: list) -> list:
    return [sys.executable, os.path.abspath(__file__), "--launch", out,
            json.dumps(spec)] + argv


def launch_child(out: str, spec: dict, argv: list):
    """``chip_smoke.py --launch OUT SPEC ARGV...``: the launcher in a
    process of its own (``repro_torch.launch.train``, ARGV its arguments);
    its log, launches, peak memory and reduction buffers go to OUT as JSON
    (exact: JSON round-trips every float). SPEC, a JSON object, asks for
    more: ``counted`` counts the kernels' launches on the device
    (``device_counted``, a fused run); ``replicas`` checksums every rank's
    replica after each step (``ReplicaCheck``, kept out of the walls and
    the peak); ``first_grads``, a path, saves there the whole velocity of
    the attention leaves after step 1, or of the leaves the regular
    expression ``first_grads_leaves`` matches (``FirstVelocity``; inside
    ``ReplicaCheck`` where there is one); ``probe`` records the head of every reduction's segments
    and means (``probe_reductions``, a per-step run); ``final_sum`` the
    device checksum
    of the final params and rule state (``engine_checksum``); ``layers``
    cuts the config to that many layers (``dataclasses.replace``, as
    ``launch.dryrun._cfg_with_blocks`` cuts it: the launcher has no depth
    flag, as the reference's has none)."""
    torch.backends.cuda.matmul.allow_tf32 = False   # as the parent runs
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_xent import fused_xent
    from repro_torch.launch import train as launcher
    from repro_torch.obs.console import process_index
    wrappers = {"fused_xent": fused_xent, "flash_attention": flash_attention}
    for w in wrappers.values():
        w.launches = 0
    args = launcher.parse_args(argv)
    if spec.get("layers"):
        import dataclasses
        resolve = launcher.resolve_config
        launcher.resolve_config = lambda a: dataclasses.replace(
            resolve(a), num_layers=spec["layers"])
    first = None
    if spec.get("first_grads"):
        first = FirstVelocity(spec["first_grads"],
                              spec.get("first_grads_leaves", ATTN_LEAF.pattern))
        build = launcher.build_model

        def capture(*a, **kw):               # the leaves' names
            first.model = build(*a, **kw)
            return first.model

        launcher.build_model = capture
    check = ReplicaCheck(spec.get("tp", False), first) \
        if spec.get("replicas") else None
    on_step = check if check is not None else first
    reductions = probe_reductions() if spec.get("probe") else None
    device = None
    if spec.get("counted"):
        res, device = device_counted(
            lambda p: launcher.run(args, profiler=p, on_step=on_step))
    else:
        res = launcher.run(args, on_step=on_step)
    peaks = [res["peak_bytes"]] + ([] if check is None else check.peaks)
    log = res["log"]
    tp = None
    if res["placement"] is not None:        # the tensor-parallel strategy
        pl = res["placement"]
        whole = pl.full(res["local_params"])
        hd = res["model"].cfg.head_dim
        attn = [lf for lf in pl.leaves
                if lf.name in ("layers.0.mixer.wq", "layers.0.mixer.wk")]
        moe = next((lf.name[:-len("router")] for lf in pl.leaves
                    if lf.name.endswith(".mlp.router")), None)
        tp = {"bytes": res["tp_bytes"],
              "whole_params": replica_agreement_of(
                  replica_checksum(whole), whole[0].device),
              "split": sum(lf.tp_dim is not None for lf in pl.leaves),
              "gathered": sum(bool(lf.gathers) for lf in pl.leaves),
              "held": sum(t.numel() for t in res["local_params"]),
              # compute heads, and the storage columns beside them
              "attn_local_heads": {lf.name.rsplit(".", 1)[-1]:
                                   lf.compute.shape[1] // hd for lf in attn},
              "attn_storage_cols": {lf.name.rsplit(".", 1)[-1]:
                                    lf.local.shape[1] for lf in attn},
              # the first MoE layer's [compute shape, storage shape]
              "moe_shapes": {lf.name.rsplit(".", 1)[-1]:
                             [list(lf.compute.shape), list(lf.local.shape)]
                             for lf in pl.leaves
                             if moe is not None and lf.name.startswith(moe)}}
        del whole
    with open(out, "w") as fh:
        json.dump({"rank": process_index(), "ranks": res["ranks"],
                   "start": res["start"], "steps": res["steps"],
                   "seconds": res["seconds"],
                   "capture_seconds": res["capture_seconds"],
                   **sequences(res),
                   **{k: getattr(log, k) for k in DP_KEYS + ("psi_std",)},
                   "wall": log.wall,
                   "launches": {k: w.launches for k, w in wrappers.items()},
                   "device_launches": device,
                   "peak_bytes": max((p for p in peaks if p is not None),
                                     default=None),
                   "reduce_bytes": res["reduce_bytes"],
                   "params": res["params"],
                   "replicas": None if check is None else check.rows,
                   "reductions": reductions, "tp": tp,
                   # an async-PS run's push records and events
                   "records": [{k: r[k] for k in ("worker", "tau", "batch",
                                                  "version")}
                               for r in res.get("records", [])],
                   "events": res.get("events", []),
                   "final_sum": engine_checksum(
                       res["local_params"], res["state"].base)
                   if spec.get("final_sum") else None}, fh)


def run_children(argvs: list, outs: list, specs: list) -> list:
    """``launch_child`` processes started together (the ranks of one run),
    each joined with a timeout; -> their JSON results."""
    procs = [subprocess.Popen(child_cmd(o, sp, a))
             for a, o, sp in zip(argvs, outs, specs)]
    try:
        for p in procs:
            p.wait(timeout=900)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode != 0]
    if bad:
        raise SystemExit(f"launcher children exited {bad}")
    out = []
    for o in outs:
        with open(o) as fh:
            out.append(json.load(fh))
    return out


def run_child(argv: list, out: str, spec: dict = None) -> dict:
    return run_children([argv], [out], [spec or {}])[0]


def phase_resume(ref: dict):
    """Kill and resume on the transformer path, each run a fresh process of
    the launcher: ``loss-prop`` with ``--chunk-steps 3 --checkpoint-every
    6`` to step 6 (the checkpoint), then ``--resume --chunk-steps 4`` to
    step 14, so the resumed chunks start mid-grid. Every step logged after
    the kill (loss, accelerate, sub_iters, batch pick) must equal ``ref``'s,
    the uninterrupted per-step run of ``phase_sched``, and the checkpoint
    the resumed run writes at step 14 must hold ``ref``'s final params,
    ISGD state and policy table bit for bit (array by array against
    ``pack_engine_state`` of ``ref``). The branch must fire after the kill.
    The checkpoint's bytes and the launcher's save and restore seconds come
    from its ``--obs-dir`` events. The directory is removed afterwards."""
    import tempfile

    from repro_torch.obs import read_jsonl
    from repro_torch.train import checkpoints as CK
    t0 = time.perf_counter()
    base = train_args("transformer") + ["--schedule", "loss-prop",
                                        "--checkpoint-every", str(RESUME_KILL)]
    with tempfile.TemporaryDirectory(prefix="resume_", dir=ROOT) as d:
        ck = os.path.join(d, "ckpt")
        legs = []
        for i, extra in enumerate((
                ["--steps", str(RESUME_KILL), "--chunk-steps", str(RESUME_K0)],
                ["--steps", str(RESUME_STEPS), "--chunk-steps", str(RESUME_K1),
                 "--resume"])):
            obs = os.path.join(d, f"obs{i}")
            legs.append(run_child(base + extra + ["--checkpoint-dir", ck,
                                                  "--obs-dir", obs],
                                  os.path.join(d, f"log{i}.json")))
            legs[-1]["events"] = [
                dict(r["data"], event=r["name"])
                for r in read_jsonl(os.path.join(obs, "metrics.p0.jsonl"))
                if r["kind"] == "event" and r["name"].startswith("checkpoint.")]
        saved = sorted(os.listdir(ck))
        with np.load(os.path.join(ck, f"ckpt_{RESUME_STEPS:08d}.npz")) as f:
            got = {k: f[k] for k in f.files if k != "__meta__"}
        model = ref["model"]
        tree, _ = CK.pack_engine_state(
            params=model.params(), state=ref["state"], step=RESUME_STEPS,
            layout=CK.layout_for(model.module), sched_state=ref["sched_state"])
        want = CK.tree_arrays(tree)
        differ = sorted(k for k in set(want) | set(got)
                        if k not in want or k not in got
                        or not np.array_equal(want[k], got[k]))
        kill_bytes = os.path.getsize(os.path.join(
            ck, f"ckpt_{RESUME_KILL:08d}.npz"))
    first, resumed = legs
    after = sequences(ref, RESUME_KILL, RESUME_STEPS - RESUME_KILL)
    same = all(resumed[k] == after[k] for k in LOG_KEYS)
    save = next(e for e in first["events"] if e["event"] == "checkpoint.save")
    restore = next(e for e in resumed["events"]
                   if e["event"] == "checkpoint.restore")
    out = dict(config=zoo_base("transformer").name, kill_step=RESUME_KILL,
               chunk_steps=[RESUME_K0, RESUME_K1], resumed_from=resumed["start"],
               last_step=resumed["steps"], saved_steps=saved,
               log_after_kill_equal=same, losses_after_kill=resumed["losses"],
               accelerated_after_kill=resumed["accelerated"],
               branch_fired_after_kill=any(resumed["accelerated"]),
               state_arrays=len(want), state_arrays_differing=differ,
               checkpoint_bytes=kill_bytes, save_seconds=save["seconds"],
               restore_seconds=restore["seconds"],
               seconds=time.perf_counter() - t0)
    emit("resume", **out)
    if resumed["start"] != RESUME_KILL or resumed["steps"] != RESUME_STEPS:
        raise SystemExit(f"resume: ran {resumed['start']}..{resumed['steps']}")
    if not same:
        raise SystemExit("resume: the resumed run's log differs from the "
                         "uninterrupted run's")
    if differ:
        raise SystemExit(f"resume: final state differs at {differ[:8]}")
    if not out["branch_fired_after_kill"]:
        raise SystemExit("resume: the accelerate branch never fired after "
                         "the kill")


# ---------------------------------------------------------------------------
# data parallelism (repro_torch.distributed): the transformer path over a
# process group; no kernel of its own, the same two kernels on every rank
# ---------------------------------------------------------------------------
DP2_STEPS = 6                              # the two gloo ranks' steps
DP_KERNELS = ("fused_xent", "flash_attention")
DP_KEYS = ("losses", "psi_bar", "limits", "accelerated", "sub_iters")
INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
               8: torch.int64}


def replica_checksum(tensors) -> torch.Tensor:
    """A 0-d int64 checksum of the bits of ``tensors`` on the device: each
    tensor's elements as integers, weighted by position, summed (int64
    arithmetic wraps), folded in order. Equal bits give equal sums."""
    acc = None
    for t in tensors:
        v = t.detach().contiguous().view(-1)
        v = v.view(INT_OF_SIZE[v.element_size()]).to(torch.int64)
        w = torch.arange(v.numel(), device=v.device) % 8191 + 1
        part = (v * w).sum() + v.sum()
        acc = part if acc is None else acc * 1000003 + part
    return acc


def replica_agreement_of(mine, dev) -> dict:
    """Every rank's checksum ``mine``, gathered in rank order: {"equal",
    "sums"}."""
    import torch.distributed as dist
    sums = [torch.zeros(1, dtype=torch.int64, device=dev)
            for _ in range(dist.get_world_size())]
    dist.all_gather(sums, mine.reshape(1))
    sums = [int(x) for x in sums]
    return {"equal": len(set(sums)) == 1, "sums": sums}


def replica_agreement(carry, tp: bool = False) -> dict:
    """Every rank's checksum of its params, optimizer state, ψ queue and
    counters after a step, gathered in rank order: {"equal", "sums"}. With
    ``tp`` (the tensor-parallel strategy) the params and velocities are
    those the placement replicates (spec all None), the rest being
    shards."""
    from repro_torch.core.reduce import tree_leaves
    state, params = carry[0], carry[1]
    dev = params[0].device
    base = list(tree_leaves(state.base))
    if tp:
        pl = params[0]._repro_placement
        keep = [not any(lf.spec) and lf.tp_dim is None for lf in pl.leaves]
        params = [p for p, k in zip(params, keep) if k]
        base = [v for v, k in zip(base, keep) if k]
    counters = torch.tensor([int(state.iter), int(state.accel_count),
                             int(state.sub_iters)], device=dev)
    mine = replica_checksum(list(params) + base
                            + tree_leaves(tuple(state.queue)) + [counters])
    return replica_agreement_of(mine, dev)


class ReplicaCheck:
    """``on_step`` of a data-parallel run: after each step every rank's
    replica checksum, gathered (``replica_agreement``), goes to ``rows``
    with the seconds it took. Its time and memory stay out of the engine's
    figures: the device is synchronised first, the peak so far is kept in
    ``peaks``, and the peak counter is reset after the checksum. ``also``,
    another ``on_step`` (``FirstVelocity``), runs inside the same timed
    span."""

    def __init__(self, tp: bool = False, also=None):
        self.rows, self.peaks, self.tp, self.also = [], [], tp, also

    def __call__(self, j: int, carry):
        dev = carry[1][0].device
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            self.peaks.append(torch.cuda.max_memory_allocated(dev))
        t0 = time.perf_counter()
        row = replica_agreement(carry, self.tp)
        if self.also is not None:
            self.also(j, carry)
        row["seconds"] = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        self.rows.append(row)


ATTN_LEAF = re.compile(r"layers\.\d+\.mixer\.w[qkvo]")


class FirstVelocity:
    """``on_step`` that saves to ``out``, after step 1, the whole velocity
    of every leaf whose name ``leaves`` matches (a regular expression;
    default the attention leaves, ``ATTN_LEAF``), f32, by name. The momentum
    rule's velocity starts at zero, so after one step it is −lr × the
    step's gradient (the data mean's), taken before any decision of ISGD
    can differ. A tensor-parallel run gathers those leaves
    (``Placement.full``, every rank taking part) and its rank 0 saves
    them. ``model``: the launcher's model (its leaves' names)."""

    def __init__(self, out: str, leaves: str = ATTN_LEAF.pattern):
        self.out, self.model, self.leaves = out, None, re.compile(leaves)

    def __call__(self, j: int, carry):
        import copy

        from repro_torch.core.reduce import tree_leaves
        from repro_torch.obs.console import process_index
        if j != 1:
            return
        vel = list(tree_leaves(carry[0].base))
        pl = getattr(carry[1][0], "_repro_placement", None)
        if pl is None:
            names = [n for n, _ in self.model.module.named_parameters()]
            keep = [i for i, n in enumerate(names)
                    if self.leaves.fullmatch(n)]
            whole = [vel[i] for i in keep]
        else:
            names = [lf.name for lf in pl.leaves]
            keep = [i for i, n in enumerate(names)
                    if self.leaves.fullmatch(n)]
            sub = copy.copy(pl)
            sub.leaves = [pl.leaves[i] for i in keep]
            whole = sub.full([vel[i] for i in keep])
        if pl is None or process_index() == 0:
            torch.save({names[i]: t.float().cpu()
                        for i, t in zip(keep, whole)}, self.out)


def first_grads_against(path: str, ref_path: str) -> dict:
    """Two runs' step-1 velocities (``FirstVelocity``) leaf by leaf:
    ‖v − v_ref‖ / ‖v_ref‖ of each leaf (``rel_by_leaf``), the largest of
    them (``rel``) and its leaf, and the largest max|v − v_ref| /
    max|v_ref| (``max_rel``), f64."""
    v, ref = torch.load(path), torch.load(ref_path)
    if sorted(v) != sorted(ref) or not ref:
        raise SystemExit(f"step-1 velocities of different leaves: "
                         f"{sorted(v)} against {sorted(ref)}")
    rel, max_rel = {}, {}
    for name, r in ref.items():
        d = v[name].double() - r.double()
        rel[name] = float(d.norm() / r.double().norm())
        max_rel[name] = float(d.abs().max() / r.double().abs().max())
    worst = max(rel, key=rel.get)
    return {"leaves": len(ref), "rel": rel[worst], "worst_leaf": worst,
            "max_rel": max(max_rel.values()), "rel_by_leaf": rel}


PROBE_HEAD = 4                   # elements of each segment a probe records


def probe_reductions() -> list:
    """Record every reduction of the data mean (``AxisReduce``: the
    exchange of its reduce-scatter, then the gather of the means), in
    order: this rank's first PROBE_HEAD elements of each segment it sends
    (``sent``, rank order; segment 0 starts with ψ and aux, the bucket's
    first slots in ``wrap_loss_and_grad``'s layout), of each segment it
    receives (``received``, rank order) and of the means it takes of them
    (``means``, the gather's input). The first record is ``init_fn``'s
    priming reduction. Each record reads the host, so a captured reduction
    (the fused engine) cannot be probed."""
    from repro_torch.core.reduce import AxisReduce
    rows, exchange, gather = [], AxisReduce.exchange, AxisReduce.gather

    def exchanged(self, bucket, out, sizes):
        exchange(self, bucket, out, sizes)
        starts = np.cumsum([0] + list(sizes[:-1])).tolist()
        rows.append({
            "sent": [bucket[a:a + min(PROBE_HEAD, n)].tolist()
                     for a, n in zip(starts, sizes)],
            "received": out[:, :PROBE_HEAD].tolist()})
        return out

    def gathered(self, x, out, group=None):
        if rows and "means" not in rows[-1] and group is None:
            rows[-1]["means"] = x[:PROBE_HEAD].tolist()
        return gather(self, x, out, group)

    AxisReduce.exchange, AxisReduce.gather = exchanged, gathered
    return rows


def f32_shard_mean(xs: list) -> float:
    """The rank-order mean of f32 values in f32, ``((x_0 + x_1) + …) / n``:
    what ``AxisReduce`` must compute, worked out here with numpy."""
    acc = np.float32(xs[0])
    for x in xs[1:]:
        acc = np.float32(acc + np.float32(x))
    return float(np.float32(acc / np.float32(len(xs))))


def shard_reduction(ranks: list) -> dict:
    """The two-rank run's reductions against their shards (``probe``): at
    every evaluation each rank's received segments must be the ranks' own
    segments for it, in rank order (so no shard is dropped or handed
    twice), each of its means the rank-order f32 mean of what it received
    bit for bit, and each step's logged ψ, on every rank, rank 0's mean of
    the ranks' ψ slots and the rank-order f32 mean of the shards' ψ bit
    for bit. The shards' ψ must differ, or the check could not tell."""
    evals = [g["reductions"][1:] for g in ranks]     # past the priming
    n, sub = len(ranks), ranks[0]["sub_iters"]
    want = ranks[0]["steps"] + sum(sub)
    out = dict(evaluations=[len(e) for e in evals], expected=want)
    if any(len(e) != want for e in evals):
        return dict(out, ok=False)
    first = np.cumsum([0] + [1 + s for s in sub[:-1]]).tolist()
    rows_ok = all(evals[r][i]["received"][q] == evals[q][i]["sent"][r]
                  for r in range(n) for q in range(n) for i in range(want))
    means_ok = all(
        e["means"] == [f32_shard_mean(col) for col in zip(*e["received"])]
        for ev in evals for e in ev)
    shard_psi = [[evals[r][i]["sent"][0][0] for i in first]
                 for r in range(n)]
    psi_ok = all(
        g["losses"][j] == evals[0][i]["means"][0] == f32_shard_mean(
            [evals[q][i]["sent"][0][0] for q in range(n)])
        for g in ranks for j, i in enumerate(first))
    distinct = all(len(set(col)) == n for col in zip(*shard_psi))
    return dict(out, segments_in_rank_order=rows_ok,
                means_are_rank_order_means=means_ok,
                psi_is_shard_mean=psi_ok, shards_distinct=distinct,
                shard_psi=shard_psi,
                ok=rows_ok and means_ok and psi_ok and distinct)


def phase_dp(per_step: dict, chunked: dict):
    """One NCCL rank (``--engine data-parallel``, no process arguments: a
    one-rank group) on ``paper-transformer`` base: per-step for 12 steps
    and fused at K = 4, each a child process (fused: the reduce-scatter's
    exchange and gather captured in the CUDA graph). The one-rank
    reduction must leave every value as it was, so each run must equal the
    single-device run of the same engine (``train``, ``chunked``) bit for
    bit: every loss, ψ̄, limit, accelerate decision and sub_iters; and it
    must launch the same kernels as often (host counts per-step, device
    counts fused: ``fused_xent`` and ``flash_attention`` per evaluation
    times steps plus trips). ms/step is printed beside the single-device
    figures, with the bytes the reduction adds (the f32 bucket and the
    receive buffer, n each at one rank); it shares the card with the
    other child phases (``child_phases``), so it is no speed figure."""
    import tempfile
    t0 = time.perf_counter()
    per_eval = launches_per_eval(zoo_base("transformer"))
    base = train_args("transformer") + ["--engine", "data-parallel"]
    with tempfile.TemporaryDirectory(prefix="dp_", dir=ROOT) as d:
        runs = {"per-step": run_child(base, os.path.join(d, "ps.json")),
                "fused": run_child(base + ["--chunk-steps", str(CHUNK)],
                                   os.path.join(d, "fused.json"),
                                   {"counted": True})}
    refs = {"per-step": per_step["log"], "fused": chunked["log"]}
    for engine, got in runs.items():
        ref = refs[engine]
        first = 1 if engine == "per-step" else CHUNK
        evals = got["steps"] + sum(got["sub_iters"])
        expect = {k: per_eval[k] * evals for k in DP_KERNELS}
        launches = (got["launches"] if engine == "per-step"
                    else {k: got["device_launches"][k] for k in DP_KERNELS})
        same = {k: got[k] == getattr(ref, k) for k in DP_KEYS}
        single = (per_step["launches"] if engine == "per-step" else expect)
        out = dict(config=zoo_base("transformer").name, engine=engine,
                   ranks=got["ranks"], backend="nccl", steps=got["steps"],
                   bit_exact=all(same.values()), equal=same,
                   losses=got["losses"], accelerated=got["accelerated"],
                   sub_iters=got["sub_iters"], launches=launches,
                   expected_launches=expect,
                   single_device_launches={k: single[k] for k in DP_KERNELS},
                   ms_per_step=ms_after_walls(got["wall"], first),
                   single_device_ms_per_step=ms_after(ref, first),
                   bucket_bytes=got["reduce_bytes"]["bucket"],
                   received_bytes=got["reduce_bytes"]["received"],
                   added_bytes=sum(got["reduce_bytes"].values()),
                   peak_mem_gib=got["peak_bytes"] / 2**30,
                   capture_seconds=got["capture_seconds"])
        emit("dp", **out)
        if got["ranks"] != 1:
            raise SystemExit(f"dp: {got['ranks']} ranks, not 1")
        if not out["bit_exact"]:
            raise SystemExit(f"dp {engine}: the one-rank run differs from "
                             f"the single-device run: {same}")
        if launches != expect or launches != out["single_device_launches"]:
            raise SystemExit(f"dp {engine}: launches {launches}, expected "
                             f"{expect}")
    emit("dp_seconds", seconds=time.perf_counter() - t0)


_PORTS: set = set()                        # handed out by free_port
_PORTS_LOCK = threading.Lock()


def free_port() -> int:
    """A free local port that no earlier call returned (``dp2`` and
    ``hybrid`` pick theirs in threads started together)."""
    import socket
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with _PORTS_LOCK:
            if port not in _PORTS:
                _PORTS.add(port)
                return port


def phase_dp2(per_step: dict):
    """Two ranks sharing the card over gloo (``--dist-backend gloo``: NCCL
    refuses two ranks on one device), per-step, ``paper-transformer`` base
    at global batch 8 (4 a rank) for DP2_STEPS steps: a real two-shard
    reduction, a reduce-scatter whose segments (0.64 GB f32 each) and
    gathered means are staged through the host. After every step the
    ranks' params, optimizer state, queue and counters must checksum alike
    (gathered across the ranks). Every reduction is held against its
    shards (``shard_reduction``): each rank's received segments are the
    ranks' own for it in rank order, its means their f32 rank-order mean,
    and each step's ψ the f32 mean of the two shards' ψ, bit for bit. Each
    rank's reduction buffers and peak are printed. Each rank's ψ must also
    stay within the bf16
    ``fused_xent`` tolerance (``numerics``) of the single-device run's on
    the same global batches (printed beside the gap a one-shard ψ shows),
    and its accelerate decisions equal wherever that run's ψ is clear of
    its limit by more than the tolerance; both ranks launch the same
    kernels as often. Each rank's peak memory and s/step are printed
    without the checksum's memory and time. A correctness check, not a
    speed figure."""
    import tempfile

    from repro_torch.kernels.numerics import TOLERANCES
    t0 = time.perf_counter()
    rtol, atol = TOLERANCES["fused_xent"]["bfloat16"]
    argv = train_args("transformer", DP2_STEPS) + [
        "--engine", "data-parallel", "--dist-backend", "gloo",
        "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "2"]
    with tempfile.TemporaryDirectory(prefix="dp2_", dir=ROOT) as d:
        ranks = run_children(
            [argv + ["--process-id", str(r)] for r in range(2)],
            [os.path.join(d, f"rank{r}.json") for r in range(2)],
            [{"replicas": True, "probe": True}] * 2)
    ref = per_step["log"]
    s_psi, s_lim = ref.losses[:DP2_STEPS], ref.limits[:DP2_STEPS]
    tol = [atol + rtol * abs(x) for x in s_psi]
    clear = [not math.isfinite(lim) or abs(p - lim) > t
             for p, lim, t in zip(s_psi, s_lim, tol)]
    per_eval = launches_per_eval(zoo_base("transformer"))
    reduction = shard_reduction(ranks)
    if "shard_psi" in reduction:           # ψ of one shard against s_psi
        reduction["one_shard_gap"] = [
            max(abs(a - b) for a, b in zip(row, s_psi))
            for row in reduction["shard_psi"]]
    out = dict(config=zoo_base("transformer").name, ranks=2, backend="gloo",
               steps=DP2_STEPS, global_batch=8, per_rank_batch=4,
               single_device_losses=s_psi, tolerance=[rtol, atol],
               max_tolerance=max(tol), reduction=reduction)
    ok = reduction["ok"]
    for g in ranks:
        dev = [abs(a - b) for a, b in zip(g["losses"], s_psi)]
        evals = g["steps"] + sum(g["sub_iters"])
        check_s = [r["seconds"] for r in g["replicas"]]
        wall = g["wall"]
        rank = dict(
            losses=g["losses"], accelerated=g["accelerated"],
            sub_iters=g["sub_iters"], max_abs_psi_dev=max(dev),
            psi_within=all(x <= t for x, t in zip(dev, tol)),
            decisions_equal_where_clear=all(
                a == b for a, b, c in zip(g["accelerated"],
                                          ref.accelerated[:DP2_STEPS], clear)
                if c),
            replicas_equal_every_step=(len(g["replicas"]) == DP2_STEPS
                                       and all(r["equal"]
                                               for r in g["replicas"])),
            launches=g["launches"],
            expected_launches={k: per_eval[k] * evals for k in DP_KERNELS},
            peak_mem_gib=g["peak_bytes"] / 2**30,
            # the steps after the first, less the checksums run between
            s_per_step=(wall[-1] - wall[0] - sum(check_s[:-1]))
            / (len(wall) - 1),
            checksum_s_per_step=sum(check_s) / len(check_s),
            reduce_bytes=g["reduce_bytes"])
        out[f"rank{g['rank']}"] = rank
        ok &= (rank["psi_within"] and rank["decisions_equal_where_clear"]
               and rank["replicas_equal_every_step"]
               and rank["launches"] == rank["expected_launches"])
    same_ranks = ([r["sums"] for r in ranks[0]["replicas"]]
                  == [r["sums"] for r in ranks[1]["replicas"]]
                  and all(ranks[0][k] == ranks[1][k] for k in DP_KEYS)
                  and ranks[0]["launches"] == ranks[1]["launches"])
    out.update(ranks_identical=same_ranks, clear_of_limit=clear,
               seconds=time.perf_counter() - t0)
    emit("dp2", **out)
    if not (ok and same_ranks):
        raise SystemExit("dp2: the two gloo ranks failed a check (above)")


def dp_parity_legs() -> list:
    """``python -m repro_torch.distributed.parity`` on the card: two ranks
    over gloo and one NCCL rank, each within the reference's 1e-5, with
    accelerations and no decision mismatch (its exit code 0)."""
    return [("dp_parity", "repro_torch.distributed.parity",
             ["--procs", str(procs), "--device", "cuda", "--backend", backend],
             "parity devices=", {"procs": procs, "backend": backend})
            for procs, backend in ((2, "gloo"), (1, "nccl"))]


def dp_parity_fields(line: str) -> dict:
    fields = dict(kv.split("=", 1) for kv in line.split() if "=" in kv)
    return {k: fields.get(k) for k in ("accelerations", "accel_mismatch",
                                       "max_param", "max_psi_bar",
                                       "max_limit", "replicas_identical")}


# ---------------------------------------------------------------------------
# the hybrid DP × TP engine, the pod axis and the zoo parity matrix
# ---------------------------------------------------------------------------
HYBRID_STEPS = 4                           # the two tensor-parallel ranks' steps


def phase_hybrid(per_step: dict) -> dict:
    """``paper-transformer`` base at full width and depth through
    ``--engine hybrid --model-parallel 2``: two ranks sharing the card over
    gloo on a ``(data=1, model=2)`` mesh, each holding 8 of the 16 query
    heads and 4 of the 8 KV heads of every layer and half of every MLP,
    the embedding and head split over the vocab (gathered for the loss),
    per-step for HYBRID_STEPS steps with the subproblem allowed to fire.
    Each rank's ψ must stay within the bf16 ``fused_xent`` tolerance of
    the single-device run's (``train``) and its decisions equal wherever
    that run's ψ is clear of its limit; the ranks' loss/ψ̄/limit logs must
    be equal bit for bit, and after every step the replicated tensors (the
    norm scales, their velocities, the ψ queue, the counters) checksum
    alike on both ranks; at the end the whole params, gathered, too. Each
    rank's kernel launches are counted on the device over the timed steps:
    ``flash_attention`` 32 an evaluation (16 layers, forward and
    recomputation, on the rank's heads) and ``fused_xent`` 1. s/step,
    peak GiB a rank and the bytes the tensor-parallel collectives move an
    evaluation (model-axis sums and parameter gathers a rank receives) are
    printed. A correctness check of the path, not a speed figure: gloo
    stages every collective through the host."""
    import tempfile

    from repro_torch.kernels.numerics import TOLERANCES
    t0 = time.perf_counter()
    rtol, atol = TOLERANCES["fused_xent"]["bfloat16"]
    argv = train_args("transformer", HYBRID_STEPS) + [
        "--engine", "hybrid", "--model-parallel", "2", "--dist-backend",
        "gloo", "--coordinator", f"127.0.0.1:{free_port()}",
        "--num-processes", "2"]
    with tempfile.TemporaryDirectory(prefix="hybrid_", dir=ROOT) as d:
        ranks = run_children(
            [argv + ["--process-id", str(r)] for r in range(2)],
            [os.path.join(d, f"rank{r}.json") for r in range(2)],
            [{"counted": True, "replicas": True, "tp": True}] * 2)
    ref = per_step["log"]
    s_psi = ref.losses[:HYBRID_STEPS]
    s_lim = ref.limits[:HYBRID_STEPS]
    tol = [atol + rtol * abs(x) for x in s_psi]
    clear = [not math.isfinite(lim) or abs(p - lim) > t
             for p, lim, t in zip(s_psi, s_lim, tol)]
    per_eval = launches_per_eval(zoo_base("transformer"))
    out = dict(config=zoo_base("transformer").name, mesh={"data": 1,
               "model": 2}, backend="gloo", steps=HYBRID_STEPS,
               global_batch=8, single_device_losses=s_psi,
               tolerance=[rtol, atol], clear_of_limit=clear)
    ok = True
    for g in ranks:
        rank, good = tp_rank_report(g, s_psi, ref.accelerated, clear, tol,
                                    per_eval)
        out[f"rank{g['rank']}"] = rank
        ok &= good and rank["attn_local_heads"] == {"wq": 8, "wk": 4}
    same_logs = all(ranks[0][k] == ranks[1][k] for k in DP_KEYS)
    out.update(logs_equal_across_ranks=same_logs,
               seconds=time.perf_counter() - t0)
    emit("hybrid", **out)
    if not (ok and same_logs):
        raise SystemExit("hybrid: the two tensor-parallel ranks failed a "
                         "check (above)")
    return {k: ranks[0]["device_launches"][k] for k in DP_KERNELS}


def tp_rank_report(g: dict, s_psi: list, s_accel: list, clear: list,
                   tol: list, per_eval: dict) -> tuple:
    """One tensor-parallel rank's child result against the single-device
    run's ψ (``s_psi``) and decisions -> (its report, whether it passed
    the checks: ψ within ``tol``, decisions equal where ``clear``, the
    replicated tensors alike after every step, the gathered whole params
    alike, the device-counted launches the per-evaluation count ×
    evaluations)."""
    steps = len(s_psi)
    dev = [abs(a - b) for a, b in zip(g["losses"], s_psi)]
    evals = g["steps"] + sum(g["sub_iters"])
    launches = {k: g["device_launches"][k] for k in DP_KERNELS}
    expect = {k: per_eval[k] * evals for k in DP_KERNELS}
    check_s = [r["seconds"] for r in g["replicas"]]
    wall = g["wall"]
    tpb = g["tp"]["bytes"]
    rank = dict(
        losses=g["losses"], accelerated=g["accelerated"],
        sub_iters=g["sub_iters"], evaluations=evals,
        max_abs_psi_dev=max(dev),
        psi_within=all(x <= t for x, t in zip(dev, tol)),
        decisions_equal_where_clear=all(
            a == b for a, b, c in zip(g["accelerated"], s_accel[:steps],
                                      clear) if c),
        replicated_equal_every_step=(
            len(g["replicas"]) == steps
            and all(r["equal"] for r in g["replicas"])),
        whole_params_equal=g["tp"]["whole_params"]["equal"],
        launches=launches, expected_launches=expect,
        launches_per_eval={k: launches[k] / evals for k in DP_KERNELS},
        attn_local_heads=g["tp"]["attn_local_heads"],
        attn_storage_cols=g["tp"]["attn_storage_cols"],
        moe_shapes=g["tp"]["moe_shapes"],
        params_held=g["tp"]["held"], params_total=g["params"],
        split_leaves=g["tp"]["split"], gathered_leaves=g["tp"]["gathered"],
        peak_mem_gib=g["peak_bytes"] / 2**30,
        s_per_step=(wall[-1] - wall[0] - sum(check_s[:-1]))
        / (len(wall) - 1),
        tp_sum_bytes_per_eval=tpb["sums"] / evals,
        tp_gather_bytes_per_eval=tpb["gathers_per_eval"],
        tp_bytes_per_eval=tpb["sums"] / evals + tpb["gathers_per_eval"],
        reduce_bytes=g["reduce_bytes"])
    ok = (rank["psi_within"] and rank["decisions_equal_where_clear"]
          and rank["replicated_equal_every_step"]
          and rank["whole_params_equal"] and launches == expect
          and all(v > 0 for v in launches.values()))
    return rank, ok


GQA_ARCH, GQA_LAYERS, GQA_MODEL = "starcoder2_3b", 2, 4
# step-1 attention gradients, ‖v − v_ref‖ / ‖v_ref‖: 1.5e-2 on an H100 in
# bf16; a reversed KV concat or a skipped KV sum reads 0.7–1.4
GQA_GRAD_RTOL = 0.05


def gqa_args(steps: int) -> list:
    """``starcoder2_3b``'s training run at full width: --batch 8 --seq
    1024, as ``train_args``."""
    return ["--arch", GQA_ARCH, "--kernels", "cuda", "--precision", "bf16",
            "--batch", "8", "--seq", "1024", "--n-seqs", "32", "--steps",
            str(steps), "--k-sigma", "1.0", "--stop", "3", "--device", "cuda"]


def phase_hybrid_gqa() -> dict:
    """The head plan's KV groups on the card: ``starcoder2_3b`` at full
    width (d 3072, 24 query and 2 KV heads of 128, d_ff 12288, vocab
    49152) cut to GQA_LAYERS layers in the child (``launch_child``'s
    ``layers``), bf16 through ``--kernels cuda``, over four gloo ranks
    sharing the card on ``(data=1, model=4)`` (``--engine hybrid
    --model-parallel 4``): KV groups of two ranks, each rank computing 6
    query heads against its one KV head while it stores a quarter of the
    columns (768 of ``wq``, 64 of ``wk``: half a head). HYBRID_STEPS
    per-step steps with the subproblem allowed to fire, beside a
    single-device run of the same config, seed and batches (a fifth
    child). ``hybrid``'s checks (``tp_rank_report``): each rank's ψ within
    the bf16 ``fused_xent`` tolerance of the single-device run's,
    decisions equal where its ψ is clear of its limit, the ranks' logs
    equal bit for bit, the replicated tensors alike after every step and
    the gathered whole params at the end, the device-counted
    ``flash_attention`` and ``fused_xent`` launches the per-evaluation
    count × evaluations; and the compute heads ``{"wq": 6, "wk": 1}``.
    ψ sits near ln V at initialisation, so its tolerance cannot see a wrong
    head plan; the step-1 gradient can: rank 0's step-1 velocity of every
    attention leaf, gathered whole (``FirstVelocity``), is held against
    the single-device run's within GQA_GRAD_RTOL of its norm, leaf by leaf
    (``first_grads_against``). Prints s/step, peak GiB a rank and the tensor-parallel bytes an
    evaluation. A correctness check, not a speed figure (gloo stages
    every collective through the host)."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    argv = gqa_args(HYBRID_STEPS)
    spec = {"layers": GQA_LAYERS}
    with tempfile.TemporaryDirectory(prefix="hybrid_gqa_", dir=ROOT) as d:
        grads = [os.path.join(d, "grads_tp.pt"), os.path.join(d, "grads.pt")]
        *ranks, single = run_children(
            tp_argvs(argv, GQA_MODEL) + [argv],
            [os.path.join(d, f"rank{r}.json") for r in range(GQA_MODEL)]
            + [os.path.join(d, "single.json")],
            [dict(spec, counted=True, replicas=True, tp=True,
                  first_grads=grads[0])] * GQA_MODEL
            + [dict(spec, first_grads=grads[1])])
        step1 = first_grads_against(*grads)
    cfg = dataclasses.replace(get_config(GQA_ARCH), num_layers=GQA_LAYERS)
    leg, ok = tp_against_single(ranks, single, launches_per_eval(cfg),
                                {"wq": 6, "wk": 1})
    out = dict(config=cfg.name, layers=GQA_LAYERS,
               heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
               mesh={"data": 1, "model": GQA_MODEL}, backend="gloo",
               steps=HYBRID_STEPS, global_batch=8, **leg,
               step1_attn_grads=dict(step1, bound=GQA_GRAD_RTOL,
                                     within=step1["rel"] <= GQA_GRAD_RTOL),
               seconds=time.perf_counter() - t0)
    emit("hybrid_gqa", **out)
    if not (ok and out["step1_attn_grads"]["within"]):
        raise SystemExit("hybrid_gqa: the four tensor-parallel ranks failed "
                         "a check (above)")
    return {k: ranks[0]["device_launches"][k] for k in DP_KERNELS}


def tp_argvs(argv: list, model: int) -> list:
    """``argv`` for each of ``model`` gloo ranks sharing the card on
    ``(data=1, model=model)`` (``--engine hybrid``), in rank order, with
    a coordinator port of their own (``free_port``)."""
    port = free_port()
    return [argv + ["--engine", "hybrid", "--model-parallel", str(model),
                    "--dist-backend", "gloo", "--coordinator",
                    f"127.0.0.1:{port}", "--num-processes", str(model),
                    "--process-id", str(r)] for r in range(model)]


def tp_against_single(ranks: list, single: dict, per_eval: dict,
                      heads: dict) -> tuple:
    """Tensor-parallel ranks' child results against a single-device run
    of the same config, seed and batches (``hybrid_gqa``, ``hybrid_moe``)
    -> (their fields, whether every check passed): ``tp_rank_report``
    with ψ held within the bf16 ``fused_xent`` tolerance of the single
    run's and decisions where its ψ is clear of its limit, layer 0's
    compute heads ``heads``, the ranks' logs equal bit for bit."""
    from repro_torch.kernels.numerics import TOLERANCES
    rtol, atol = TOLERANCES["fused_xent"]["bfloat16"]
    s_psi, s_lim = single["losses"], single["limits"]
    tol = [atol + rtol * abs(x) for x in s_psi]
    clear = [not math.isfinite(lim) or abs(p - lim) > t
             for p, lim, t in zip(s_psi, s_lim, tol)]
    out = dict(single_device_losses=s_psi,
               single_device_accelerated=single["accelerated"],
               tolerance=[rtol, atol], clear_of_limit=clear)
    ok = True
    for g in ranks:
        rank, good = tp_rank_report(g, s_psi, single["accelerated"], clear,
                                    tol, per_eval)
        out[f"rank{g['rank']}"] = rank
        ok &= good and rank["attn_local_heads"] == heads
    same = all(r[k] == ranks[0][k] for r in ranks for k in DP_KEYS)
    out["logs_equal_across_ranks"] = same
    return out, ok and same


MOE_LAYERS = 4                             # hybrid_moe: paper-moe's first 4, 2 MoE
# At initialisation a bf16 run's step-1 MoE gradients sit 0.07–0.20 of
# their norm from an f32 run's, split or not (routing flips and capacity
# drops; CPU, paper-moe at 4 × 128 tokens), so ``hybrid_moe`` holds the
# split's distance to an f32 single-device run within GQA_GRAD_RTOL of the
# bf16 single-device run's; the gates without ``copy_in`` read 0.67 in f32.
# hybrid_moe's legs: model ranks -> (mode, layer 0's compute heads a rank)
MOE_LEGS = {4: ("experts", {"wq": 3, "wk": 1}),
            3: ("within", {"wq": 12, "wk": 4})}
MOE_ATTN = (8, 1024, 3, 1, 64)             # a (1, 4) rank's flash_attention


def moe_rank_shapes(cfg, model: int) -> dict:
    """A rank's [compute shape, storage shape] of each MoE leaf on
    ``(data=1, model)``: E/M whole experts where M divides E (the router's
    storage its E/M columns), else every expert's ``moe_d_ff``/M columns
    (rows of ``wo``); the router computed whole."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    if E % model == 0:
        e, f, r = E // model, ff, E // model
    else:
        e, f, r = E, ff // model, E
    return {"router": [[d, E], [d, r]], "wg": [[e, d, f]] * 2,
            "wi": [[e, d, f]] * 2, "wo": [[e, f, d]] * 2}


def phase_hybrid_moe() -> dict:
    """The MoE split on the card: ``paper-moe`` base at full width (d 768,
    12 query and 4 KV heads of 64, top-2 of 8 experts, ``moe_d_ff`` 1536,
    vocab 32768) cut to MOE_LAYERS layers (two MoE layers), bf16 through
    ``--kernels cuda``, HYBRID_STEPS per-step steps, on gloo ranks sharing
    the card: four on ``(1, 4)``, expert parallel (2 experts a rank; 3
    query heads on one KV head), then three on ``(1, 3)``, within each
    expert (512 of every expert's ``moe_d_ff`` a rank; attention whole:
    3 does not divide the 4 KV heads), beside single-device runs of the
    same config, seed and batches in bf16 and in f32. ``hybrid_gqa``'s
    checks against the bf16 run (``tp_against_single``: ψ, decisions,
    logs, replicated tensors and whole params alike, device-counted
    launches), each rank's MoE compute and storage shapes
    (``moe_rank_shapes``), and rank 0's step-1 velocity of every MoE
    layer's router and experts, gathered whole: leaf by leaf its distance
    to the f32 run's within GQA_GRAD_RTOL of the bf16 single-device run's
    (the bf16 floor, above MOE_LAYERS). The router's gradient is whole
    only if the gates' gradient was summed over the model ranks. -> each
    leg's rank-0 device launches, by mode. A correctness check, not a
    speed figure (gloo stages every collective through the host)."""
    import dataclasses
    import tempfile
    t0 = time.perf_counter()
    cfg = dataclasses.replace(zoo_base("moe"), num_layers=MOE_LAYERS)
    moe = [str(i) for i in range(MOE_LAYERS) if cfg._is_moe_layer(i)]
    leaves = rf"layers\.({'|'.join(moe)})\.mlp\.(router|wg|wi|wo)"
    argv = train_args("moe", HYBRID_STEPS)
    exact_argv = [("f32" if a == "bf16" else a) for a in argv]
    spec = {"layers": MOE_LAYERS, "first_grads_leaves": leaves}
    per_eval = launches_per_eval(cfg)
    out = dict(config=cfg.name, layers=MOE_LAYERS, moe_layers=moe,
               experts=[cfg.num_experts, cfg.top_k, cfg.moe_d_ff],
               backend="gloo", steps=HYBRID_STEPS, global_batch=8)
    ok, launches, single = True, {}, None
    with tempfile.TemporaryDirectory(prefix="hybrid_moe_", dir=ROOT) as d:
        ref, exact = os.path.join(d, "grads.pt"), os.path.join(d, "f32.pt")
        for M, (mode, heads) in MOE_LEGS.items():
            grads = os.path.join(d, f"grads_{mode}.pt")
            first = single is None          # the single runs beside leg 1
            runs = run_children(
                tp_argvs(argv, M) + ([argv, exact_argv] if first else []),
                [os.path.join(d, f"{mode}{r}.json") for r in range(M)]
                + ([os.path.join(d, f"single{k}.json") for k in (16, 32)]
                   if first else []),
                [dict(spec, counted=True, replicas=True, tp=True,
                      first_grads=grads)] * M
                + ([dict(spec, first_grads=ref),
                    dict(spec, first_grads=exact)] if first else []))
            if first:
                *runs, single, _ = runs
                floor = first_grads_against(ref, exact)
                out["step1_bf16_single_against_f32"] = floor
            leg, good = tp_against_single(runs, single, per_eval, heads)
            want = moe_rank_shapes(cfg, M)
            shapes = all(leg[f"rank{r}"]["moe_shapes"] == want
                         for r in range(M))
            step1 = first_grads_against(grads, exact)
            excess = max(step1["rel_by_leaf"][n] - r
                         for n, r in floor["rel_by_leaf"].items())
            within = excess <= GQA_GRAD_RTOL
            out[mode] = dict(mesh={"data": 1, "model": M}, **leg,
                             moe_shapes_expected=want, moe_shapes_ok=shapes,
                             step1_moe_grads=dict(
                                 step1, bound=GQA_GRAD_RTOL,
                                 excess_over_bf16_single=excess,
                                 within=within,
                                 against_bf16_single=first_grads_against(
                                     grads, ref)["rel"]))
            ok &= good and shapes and within
            launches[mode] = {k: runs[0]["device_launches"][k]
                              for k in DP_KERNELS}
    out["seconds"] = time.perf_counter() - t0
    emit("hybrid_moe", **out)
    if not ok:
        raise SystemExit("hybrid_moe: the tensor-parallel ranks failed a "
                         "check (above)")
    return launches


def start_harness(module: str, args: list) -> dict:
    """Start ``python -m MODULE ARGS`` on the card, its output to
    temporary files (a pipe left unread could stall it)."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", module] + args, cwd=ROOT,
                            env=env, stdout=out, stderr=err, text=True)
    return {"proc": proc, "out": out, "err": err, "module": module,
            "args": args, "t0": time.perf_counter()}


def finish_harness(h: dict, ok_prefix: str, timeout: int = 600) -> dict:
    """Join a started harness (killed past ``timeout`` seconds from its
    start) -> its last ``ok_prefix`` line's fields; a nonzero exit or a
    line that does not end in ``-> OK`` fails."""
    proc = h["proc"]
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - h["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    h["out"].seek(0)
    h["err"].seek(0)
    stdout, stderr = h["out"].read(), h["err"].read()
    line = next((l for l in reversed(stdout.splitlines())
                 if l.startswith(ok_prefix)), "")
    res = {"args": h["args"], "rc": proc.returncode, "line": line,
           "seconds": time.perf_counter() - h["t0"]}
    if proc.returncode != 0 or not line.endswith("-> OK"):
        raise SystemExit(f"{h['module']} {h['args']}: rc {proc.returncode}\n"
                         f"{stdout[-3000:]}\n{stderr[-4000:]}")
    return res


def run_legs(legs: list) -> None:
    """The harness legs ``(phase, module, args, ok_prefix, fields)``, each
    a fresh process on toy problems, all started at once and joined in
    order (a leg's ``seconds`` include the others' share of the card and
    the host); one line per leg, then any failure raises."""
    started = [(leg, start_harness(leg[1], leg[2])) for leg in legs]
    failures = []
    for (phase, module, args, ok_prefix, fields), h in started:
        try:
            res = finish_harness(h, ok_prefix)
        except SystemExit as e:
            failures.append(str(e))
            continue
        if phase == "dp_parity":
            res.update(dp_parity_fields(res["line"]))
        emit(phase, **fields, **res)
    if failures:
        raise SystemExit("\n".join(failures))


def hybrid_parity_legs() -> list:
    """``repro_torch.distributed.hybrid_parity`` on the card: two gloo ranks
    (the bit-exact ``hybrid(1,1)``, ``hybrid(n,1)``, ``hybrid(1,n)`` legs,
    ``sharded-tp(model=2)`` within 1e-5, ``data-parallel``; the fused legs
    need NCCL and are left out there), then one NCCL rank (the fused
    ``chunked`` and ``sched-fcpr`` legs, captured)."""
    return [("hybrid_parity", "repro_torch.distributed.hybrid_parity",
             ["--procs", str(procs), "--device", "cuda", "--backend", backend,
              "--verbose"], "hybrid-parity", {"backend": backend})
            for procs, backend in ((2, "gloo"), (1, "nccl"))]


def multihost_parity_legs() -> list:
    """``repro_torch.distributed.multihost_parity`` on the card: four gloo
    ranks as two nodes on ``(pod=2, data=2)`` against four on
    ``(data=4)``, the reference's dim-6 problem, bit for bit (the per-step
    leg; the fused legs need NCCL), the stripes' union the single-node
    epoch."""
    return [("multihost_parity", "repro_torch.distributed.multihost_parity",
             ["--procs", "4", "--device", "cuda", "--backend", "gloo",
              "--verbose"], "multihost-parity", {})]


def zoo_parity_legs() -> list:
    """``repro_torch.train.zoo_parity`` on the card at the tiny tier: the
    per-step against fused legs (CUDA graphs) bit for bit on the three
    bodies, the frozen-LR control, ``sched-fcpr``, the hybrid ``(1, 1)``
    leg over one NCCL rank, and the kernel leg: ``--kernels cuda`` against
    ``reference`` in f32 within ``numerics.TOLERANCES``."""
    return [("zoo_parity", "repro_torch.train.zoo_parity",
             ["--device", "cuda", "--procs", "1", "--verbose"], "zoo-parity",
             {})]


# ---------------------------------------------------------------------------
# the asynchronous parameter server (repro_torch.distributed.async_ps): no
# kernel of its own; each worker's evaluation runs the same two kernels
# ---------------------------------------------------------------------------
ASYNC_PUSHES = 12
ASYNC_KILL = 6                             # async_resume: the checkpoint's push
ASYNC_KEYS = ("losses", "psi_bar", "psi_std", "limits", "accelerated",
              "sub_iters")


def async_args(workers: int, staleness: int, *extra) -> list:
    """The ``train`` phase's run through ``--engine async-ps``."""
    return train_args("transformer", ASYNC_PUSHES) + [
        "--engine", "async-ps", "--workers", str(workers),
        "--max-staleness", str(staleness), *extra]


def engine_checksum(params, base) -> int:
    """``replica_checksum`` of a run's params and rule state."""
    from repro_torch.core.reduce import tree_leaves
    return int(replica_checksum(list(params) + tree_leaves(base)))


def phase_async_ps(per_step: dict) -> dict:
    """One worker at staleness 0 through ``--engine async-ps`` on
    ``paper-transformer`` base, 12 pushes, in this process: bit for bit
    the per-step run of ``train`` (every loss, ψ̄, σ, limit, accelerate
    decision and sub_iters; the final params and velocity by device
    checksum), with the same launches of ``fused_xent`` and
    ``flash_attention`` (counted on the device from after the warm-up).
    ms a push beside the per-step ms/step of the same call, and the peak
    (server, one replica, the pulled snapshot, the activations). -> the
    run's result, with its device launches."""
    from repro_torch.launch import train as launcher
    t0 = time.perf_counter()
    args = launcher.parse_args(async_args(1, 0))
    res, launches = device_counted(lambda p: launcher.run(args, profiler=p))
    log, ref = res["log"], per_step["log"]
    evals = res["steps"] + int(res["state"].sub_iters)
    per_eval = launches_per_eval(zoo_base("transformer"))
    got = {k: launches[k] for k in DP_KERNELS}
    same = {k: getattr(log, k) == getattr(ref, k) for k in ASYNC_KEYS}
    final = engine_checksum(res["model"].params(), res["state"].base)
    out = dict(config=zoo_base("transformer").name, workers=1,
               max_staleness=0, pushes=res["steps"], bit_exact=all(
                   same.values()), equal=same,
               final_state_equal=final == per_step["final_sum"],
               losses=log.losses, accelerated=log.accelerated,
               sub_iters=log.sub_iters,
               taus=[r["tau"] for r in res["records"]],
               launches=got,
               expected_launches={k: per_eval[k] * evals for k in DP_KERNELS},
               per_step_launches={k: per_step["launches"][k]
                                  for k in DP_KERNELS},
               ms_per_push=ms_after(log, 1),
               per_step_ms_per_step=ms_after(ref, 1),
               warmup_seconds=res["warmup_seconds"],
               peak_mem_gib=res["peak_bytes"] / 2**30,
               per_step_peak_gib=per_step["peak_bytes"] / 2**30,
               seconds=time.perf_counter() - t0)
    emit("async_ps", **out)
    if not (out["bit_exact"] and out["final_state_equal"]):
        raise SystemExit(f"async_ps: the one-worker run differs from the "
                         f"per-step run: {same}, final state equal "
                         f"{out['final_state_equal']}")
    if got != out["expected_launches"] or got != out["per_step_launches"]:
        raise SystemExit(f"async_ps: launches {got}, expected "
                         f"{out['expected_launches']}")
    if res["steps"] != ASYNC_PUSHES or any(out["taus"]):
        raise SystemExit(f"async_ps: {res['steps']} pushes, taus "
                         f"{out['taus']}")
    return dict(res, device_launches=launches)


class SnapshotSums:
    """``snapshot_hook`` of an async run: each pulled snapshot's device
    checksum (params and base, ``replica_checksum``) when it is pulled and
    again when its push has landed; the sums stay on the device until
    ``rows``. Equal sums: nobody wrote the snapshot in between."""

    def __init__(self):
        self.sums, self.lock = {}, threading.Lock()

    def __call__(self, event, wid, k, snap):
        from repro_torch.core.reduce import tree_leaves
        s = replica_checksum(list(snap.params) + tree_leaves(snap.base))
        with self.lock:
            self.sums.setdefault((wid, k), {})[event] = (snap.version, s)

    def rows(self) -> list:
        return [{"worker": w, "step": k, "version": v["pull"][0],
                 "pull": int(v["pull"][1]), "push": int(v["push"][1])}
                for (w, k), v in sorted(self.sums.items())]


def phase_async_ps2(per_step: dict):
    """Two workers at staleness 1 (``--staleness-decay inverse``) on
    ``paper-transformer`` base, 12 pushes (6 a worker), in this process,
    both threads on the default stream: every τ recorded and within
    (2·1+1)·(2−1) = 3; the server at version 12; each worker's pushes the
    global batches k·2 + w; every ψ finite and the walls marked estimated;
    the launches counted on the device, one evaluation a push plus the
    trips. Each snapshot is checksummed on the device at its pull and
    again when its push lands (``SnapshotSums``): equal, so no thread
    wrote it. s a push (the checksums included), τ, the folds taken (the
    pushes with τ > 0) and the peak."""
    from repro_torch.launch import train as launcher
    t0 = time.perf_counter()
    args = launcher.parse_args(async_args(2, 1, "--staleness-decay",
                                          "inverse"))
    sums = SnapshotSums()
    res, launches = device_counted(
        lambda p: launcher.run(args, profiler=p, snapshot_hook=sums))
    recs, log = res["records"], res["log"]
    taus = [r["tau"] for r in recs]
    bound = (2 * 1 + 1) * (2 - 1)
    stripes = {w: [r["batch"] for r in recs if r["worker"] == w]
               for w in (0, 1)}
    rows = sums.rows()
    evals = res["steps"] + int(res["state"].sub_iters)
    per_eval = launches_per_eval(zoo_base("transformer"))
    got = {k: launches[k] for k in DP_KERNELS}
    out = dict(config=zoo_base("transformer").name, workers=2,
               max_staleness=1, decay="inverse", pushes=len(recs),
               version=res["steps"], taus=taus,
               mean_tau=sum(taus) / len(taus), max_tau=max(taus),
               tau_bound=bound, folds=sum(t > 0 for t in taus),
               stripes=stripes,
               stripes_ok=all(stripes[w] == [k * 2 + w for k in range(6)]
                              for w in (0, 1)),
               losses=log.losses, workers_in_order=[r["worker"] for r in recs],
               accelerated=log.accelerated, sub_iters=log.sub_iters,
               psi_finite=all(math.isfinite(x) for x in log.losses),
               walls_estimated=all(log.wall_est),
               snapshots=len(rows),
               snapshots_unwritten=all(r["pull"] == r["push"] for r in rows),
               launches=got,
               expected_launches={k: per_eval[k] * evals for k in DP_KERNELS},
               s_per_push=(log.wall[-1] - log.wall[0]) / (len(recs) - 1),
               per_step_s_per_step=ms_after(per_step["log"], 1) / 1e3,
               warmup_seconds=res["warmup_seconds"],
               peak_mem_gib=res["peak_bytes"] / 2**30,
               seconds=time.perf_counter() - t0)
    emit("async_ps2", **out)
    ok = (max(taus) <= bound and res["steps"] == ASYNC_PUSHES
          and len(recs) == ASYNC_PUSHES and out["stripes_ok"]
          and out["psi_finite"] and out["walls_estimated"]
          and len(rows) == ASYNC_PUSHES and out["snapshots_unwritten"]
          and got == out["expected_launches"])
    if not ok:
        raise SystemExit("async_ps2: a check failed (above)")


def phase_async_resume(ref: dict):
    """Kill and resume the one-worker run, each leg a fresh process of the
    launcher: ``--checkpoint-every 6 --steps 6`` (the server writes the
    checkpoint under its lock at version 6), then ``--resume --steps 12``.
    The resumed pushes (loss, ψ̄, σ, limit, decision, sub_iters) must equal
    pushes 7–12 of ``async_ps``'s uninterrupted run, and the checkpoint the
    resumed run writes at version 12 must hold that run's final params,
    ISGD state and server clocks bit for bit (array by array against
    ``pack_engine_state``). The checkpoint's bytes and the save and
    restore seconds come from the legs' ``--obs-dir`` events. The
    directory is removed afterwards."""
    import tempfile

    from repro_torch.obs import read_jsonl
    from repro_torch.train import checkpoints as CK
    t0 = time.perf_counter()
    base = async_args(1, 0, "--checkpoint-every", str(ASYNC_KILL))
    with tempfile.TemporaryDirectory(prefix="async_resume_", dir=ROOT) as d:
        ck = os.path.join(d, "ckpt")
        legs = []
        for i, extra in enumerate((["--steps", str(ASYNC_KILL)],
                                   ["--steps", str(ASYNC_PUSHES),
                                    "--resume"])):
            obs = os.path.join(d, f"obs{i}")
            legs.append(run_child(base + extra + ["--checkpoint-dir", ck,
                                                  "--obs-dir", obs],
                                  os.path.join(d, f"log{i}.json")))
            legs[-1]["ckpt_events"] = [
                dict(r["data"], event=r["name"])
                for r in read_jsonl(os.path.join(obs, "metrics.p0.jsonl"))
                if r["kind"] == "event" and r["name"].startswith("checkpoint.")]
        saved = sorted(os.listdir(ck))
        with np.load(os.path.join(ck, f"ckpt_{ASYNC_PUSHES:08d}.npz")) as f:
            got = {k: f[k] for k in f.files if k != "__meta__"}
            meta_server = json.loads(str(f["__meta__"]))["extra"]["server"]
        model = ref["model"]
        tree, _ = CK.pack_engine_state(
            params=model.params(), state=ref["state"], step=ASYNC_PUSHES,
            layout=CK.layout_for(model.module))
        want = CK.tree_arrays(tree)
        differ = sorted(k for k in set(want) | set(got)
                        if k not in want or k not in got
                        or not np.array_equal(want[k], got[k]))
        kill_bytes = os.path.getsize(os.path.join(
            ck, f"ckpt_{ASYNC_KILL:08d}.npz"))
    first, resumed = legs
    log = ref["log"]
    same = {k: resumed[k] == getattr(log, k)[ASYNC_KILL:] for k in ASYNC_KEYS}
    save = next(e for e in first["ckpt_events"]
                if e["event"] == "checkpoint.save")
    restore = next(e for e in resumed["ckpt_events"]
                   if e["event"] == "checkpoint.restore")
    out = dict(config=zoo_base("transformer").name, kill_push=ASYNC_KILL,
               resumed_from=resumed["start"], last_push=resumed["steps"],
               saved=saved, server=meta_server, log_after_kill_equal=same,
               losses_after_kill=resumed["losses"],
               accelerated_after_kill=resumed["accelerated"],
               state_arrays=len(want), state_arrays_differing=differ,
               checkpoint_bytes=kill_bytes, save_seconds=save["seconds"],
               restore_seconds=restore["seconds"],
               seconds=time.perf_counter() - t0)
    emit("async_resume", **out)
    if (resumed["start"], resumed["steps"]) != (ASYNC_KILL, ASYNC_PUSHES):
        raise SystemExit(f"async_resume: ran {resumed['start']}.."
                         f"{resumed['steps']}")
    if not all(same.values()) or differ:
        raise SystemExit(f"async_resume: not bit for bit: {same}, "
                         f"{differ[:8]}")
    if meta_server != {"version": ASYNC_PUSHES,
                       "pushed": {"0": ASYNC_PUSHES}}:
        raise SystemExit(f"async_resume: server clocks {meta_server}")


FAULT_TINY = ["--model", "transformer", "--tier", "tiny", "--kernels",
              "cuda", "--precision", "bf16", "--batch", "4", "--seq", "64",
              "--n-seqs", "32", "--k-sigma", "1.0", "--stop", "3",
              "--device", "cuda", "--engine", "async-ps", "--verify-pushes"]
FAULT_DEADLINE = 1.5                       # s; a tiny step takes well under


def phase_async_faults():
    """Fault handling on ``paper-transformer`` tiny on the card, with
    ``--verify-pushes``, four fresh launcher processes at once: (1) three
    elastic workers in lockstep, ``--deadline 1.5``, worker 1 crashing at
    its step 2, worker 2 hanging 5 s at its step 3 and worker 0's pushes
    at steps 1 and 4 corrupted and failed in transit: the run completes
    with worker 1 evicted and its crash recorded, worker 2 evicted past the
    deadline, the survivors re-striped (worker 0 alone takes every global
    step after the second eviction), every retried push landed; (2) one
    worker with only the corrupt and transient events and (3) the clean
    one-worker run: bit for bit (log and final params by device
    checksum); (4) two workers without ``--elastic``, worker 0 hanging
    past the deadline: the run exits with ``WorkerStalled`` naming worker
    0."""
    import tempfile
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    dl = ["--deadline", str(FAULT_DEADLINE)]
    stall = [sys.executable, "-m", "repro_torch.launch.train", *FAULT_TINY,
             "--workers", "2", "--max-staleness", "0", "--steps", "16", *dl,
             "--fault-plan", "hang@0:2:seconds=5"]
    elastic = FAULT_TINY + [
        "--workers", "3", "--max-staleness", "0", "--steps", "24",
        "--elastic", *dl, "--fault-plan",
        "crash@1:2;hang@2:3:seconds=5;corrupt@0:1;transient@0:4"]
    one = FAULT_TINY + ["--workers", "1", "--steps", "8"]
    faulty = one + ["--fault-plan", "corrupt@0:1;transient@0:3"]
    with tempfile.TemporaryDirectory(prefix="async_faults_", dir=ROOT) as d:
        proc = subprocess.Popen(stall, cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            el, fa, cl = run_children(
                [elastic, faulty, one],
                [os.path.join(d, f"{n}.json") for n in ("el", "fa", "cl")],
                [{"final_sum": True}] * 3)
            so, se = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    kinds = [(e["event"], e["worker"]) for e in el["events"]]
    evicts = {e["worker"]: e for e in el["events"] if e["event"] == "evict"}
    after = [r for r in el["records"] if r["version"] >
             max((e["at_version"] for e in evicts.values()), default=0)]
    restriped = (sorted(evicts) == [1, 2]
                 and all(r["worker"] == 0 for r in after)
                 and [r["batch"] for r in after]
                 == list(range(after[0]["batch"], after[0]["batch"]
                               + len(after))) if after else False)
    crash = next((e for e in el["events"] if e["event"] == "crash"), {})
    same = {k: fa[k] == cl[k] for k in ASYNC_KEYS}
    stalled = "WorkerStalled" in se and "worker 0 stalled" in se
    out = dict(config="paper-transformer-tiny", deadline_s=FAULT_DEADLINE,
               elastic=dict(events=kinds, pushes=len(el["records"]),
                            evict_reasons={w: e["reason"]
                                           for w, e in evicts.items()},
                            survivors=[e["survivors"]
                                       for e in evicts.values()],
                            crash_error=crash.get("error"),
                            pushes_after_evictions=len(after),
                            batches_after_evictions=[r["batch"]
                                                     for r in after],
                            restriped=restriped, seconds=el["seconds"]),
               retry=dict(equal=same, final_sum_equal=(
                   fa["final_sum"] == cl["final_sum"]), pushes=len(fa[
                       "records"])),
               stall=dict(rc=proc.returncode, worker_stalled=stalled,
                          message=next((l for l in se.splitlines()
                                        if "stalled" in l), "")[:300]),
               seconds=time.perf_counter() - t0)
    emit("async_faults", **out)
    if not (restriped and "deadline" in evicts.get(2, {}).get("reason", "")
            and "InjectedCrash" in (crash.get("error") or "")
            and crash.get("worker") == 1):
        raise SystemExit("async_faults: the elastic run's evictions or "
                         "re-striping are wrong (above)")
    if not (all(same.values()) and out["retry"]["final_sum_equal"]):
        raise SystemExit("async_faults: the retried pushes are not bit for "
                         "bit the clean run")
    if proc.returncode == 0 or not stalled:
        raise SystemExit(f"async_faults: the non-elastic stall ended rc "
                         f"{proc.returncode}:\n{so[-2000:]}\n{se[-3000:]}")


def async_parity_legs() -> list:
    """``repro_torch.distributed.async_ps.parity`` on the card: one worker
    bit for bit with the per-step engine, then two workers at staleness 2
    within ψ̄ tolerance 0.25 and τ within its bound."""
    return [("async_parity", "repro_torch.distributed.async_ps.parity", args,
             "async-ps parity", {})
            for args in (["--device", "cuda"],
                         ["--device", "cuda", "--workers", "2",
                          "--max-staleness", "2", "--steps", "64", "--tol",
                          "0.25"])]


# ---------------------------------------------------------------------------
# serving (repro_torch.serve): no TPU kernel in the reference, none here
# ---------------------------------------------------------------------------
SERVE_RUN = ["--requests", "48", "--mixed-lengths", "--prompt-len", "128",
             "--decode-steps", "64", "--max-seq", "1024", "--max-batch", "16"]
SERVE_ZOO_RUN = ["--requests", "16", "--mixed-lengths", "--prompt-len", "128",
                 "--decode-steps", "64", "--max-seq", "1024", "--max-batch",
                 "16"]
ONESHOT_RUN = ["--engine", "oneshot", "--batch", "16", "--prompt-len", "512",
               "--decode-steps", "64", "--max-seq", "1024"]
# relative in norm, the reference's serving tolerances (tests/test_serve.py)
SERVE_TOL = {"prefill": 3e-2, "decode": 5e-2}
FULL_FORWARD_STEPS = 8
DEV = "cuda"                               # the serving phases' device
PUBLISH_STEPS, PUBLISH_EVERY = 4, 4


def margin_tol() -> tuple:
    """(rtol, atol): the bf16 tolerance of ``repro_torch.kernels.numerics``
    (its loosest bf16 row). Two computations of a logit x may differ by
    atol + rtol·|x| (the logits are the bf16 head product, so a margin is
    a whole number of bf16 steps: 0.03125 at |x| in [4, 8)), so a greedy
    token whose top-2 margin is below that may flip between two batchings
    of the same request."""
    from repro_torch.kernels.numerics import TOLERANCES
    return tuple(max(t["bfloat16"][i] for t in TOLERANCES.values())
                 for i in (0, 1))


def serve_args(model: str, run: list) -> list:
    return ["--model", model, "--tier", "base", "--precision", "bf16",
            "--kernels", "cuda", "--device", DEV] + run


def rel_norm(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def slot_state(kv) -> list:
    return [t.clone() for t in kv.tensors()]


def set_slot_state(kv, saved: list) -> None:
    for t, s in zip(kv.tensors(), saved):
        t.copy_(s)


def fill_slots(kv, reqs) -> list:
    """Admit the first ``max_batch`` requests into slots 0.. -> their first
    tokens."""
    return [kv.admit(slot, r.prompt)
            for slot, r in enumerate(reqs[:kv.max_batch])]


def graph_vs_eager(kv, steps: int = 3) -> list:
    """From the current slot state, ``steps`` decodes, each replayed and
    then run eagerly from the same state: True where tokens, logits,
    cursors and every cache tensor agree bit for bit."""
    same = []
    for _ in range(steps):
        saved = slot_state(kv)
        tok_g = kv.decode()
        after = slot_state(kv)
        set_slot_state(kv, saved)
        tok_e = kv.decode(eager=True)
        same.append(bool(np.array_equal(tok_g, tok_e)) and all(
            torch.equal(a, b) for a, b in zip(kv.tensors(), after)))
    return same


def oneshot_reference(model, reqs, max_seq: int) -> dict:
    """Each request's greedy continuation through the one-shot path
    (requests of one prompt length and budget batched together) and, at
    each position, the top-2 margin of its logits and the top logit:
    {rid: (tokens, margins, tops)}."""
    vocab = model.cfg.vocab_size
    groups = {}
    for r in reqs:
        groups.setdefault((len(r.prompt), r.max_new_tokens), []).append(r)
    out = {}
    from repro_torch.serve import merge_prefill_cache
    for (plen, steps), rs in groups.items():
        prompts = torch.from_numpy(np.stack([r.prompt for r in rs])).to(DEV)
        logits, pre = model.prefill_fn({"tokens": prompts})
        cache = merge_prefill_cache(model.init_cache(len(rs), max_seq), pre)
        cache["t"] = plen
        toks, margins, tops = [], [], []
        for i in range(steps):
            top = torch.topk(logits[:, :vocab], 2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).cpu())
            tops.append(top[:, 0].cpu())
            toks.append(torch.argmax(logits[:, :vocab], -1))
            if i + 1 < steps:
                logits, cache = model.decode_fn(cache, toks[-1][:, None])
        toks = torch.stack(toks, 1).cpu().tolist()
        margins = torch.stack(margins, 1).tolist()
        tops = torch.stack(tops, 1).tolist()
        for j, r in enumerate(rs):
            out[r.rid] = (toks[j], margins[j], tops[j])
    return out


def against_oneshot(comps, ref: dict, tol: tuple) -> dict:
    """The margin rule: a continuous request must equal its one-shot
    continuation, or first diverge at a position whose one-shot top-2
    margin is below the bf16 tolerance ``tol`` = (rtol, atol) at its top
    logit x, atol + rtol·|x| (a near-tie the batching can flip)."""
    rtol, atol = tol
    agree, excused, bad = 0, [], []
    for c in comps:
        want, margins, tops = ref[c.rid]
        i = next((i for i, (a, b) in enumerate(zip(c.tokens, want))
                  if a != b), None)
        if i is None and len(c.tokens) == len(want):
            agree += 1
            continue
        row = {"rid": c.rid, "position": i}
        if i is not None:
            row.update(margin=margins[i], top=tops[i],
                       allowed=atol + rtol * abs(tops[i]))
        (excused if i is not None and margins[i] < row["allowed"]
         else bad).append(row)
    return {"requests": len(comps), "agree_in_full": agree,
            "diverged_at_near_tie": excused, "diverged": bad,
            "margin_rtol_atol": list(tol)}


def against_full_forward(model, kv, reqs) -> list:
    """Requests admitted into slots 0.. of ``kv`` and decoded
    FULL_FORWARD_STEPS steps through the decode graph: the prefill logits
    and each step's logits (``kv.logits``) against the full forward over
    the prompt and the generated tokens, relative in norm."""
    from repro_torch.models import transformer as T
    kv.active.fill_(False)
    pre_logits, gen = [], []
    for slot, r in enumerate(reqs):
        gen.append([kv.admit(slot, r.prompt)])
        pre_logits.append(model.prefill_fn({"tokens": torch.from_numpy(
            r.prompt[None]).to(DEV)})[0][0])
    step_logits = []
    for _ in range(FULL_FORWARD_STEPS):
        toks = kv.decode()
        step_logits.append(kv.logits[:len(reqs)].clone())
        for i in range(len(reqs)):
            gen[i].append(int(toks[i]))
    out = []
    for i, r in enumerate(reqs):
        seq = np.concatenate([r.prompt, gen[i][:FULL_FORWARD_STEPS]])
        with torch.no_grad():
            h, _ = T.forward(model.module, torch.from_numpy(seq[None]).to(DEV),
                             remat=False)
            full = T.logits_head(model.module, h)[0]
        plen = len(r.prompt)
        out.append({"rid": r.rid, "prompt": plen,
                    "prefill": rel_norm(pre_logits[i], full[plen - 1]),
                    "decode": [rel_norm(step_logits[j][i], full[plen + j])
                               for j in range(FULL_FORWARD_STEPS)]})
        kv.retire(i)
    return out


def decode_times(kv, reps: int = 20) -> dict:
    """ms per decode step with every slot parked (each slot still runs the
    whole step; the cursors stay): the graph's device time (``cuda_ms`` of
    one replay), and host walls of ``decode()`` (replay and token fetch)
    and ``decode(eager=True)``. The state is restored afterwards."""
    saved = slot_state(kv)
    kv.active.fill_(False)
    graph_dev = cuda_ms(kv._graph.replay)
    profile = replay_profile(kv)
    ops = eager_op_profile(kv)
    walls = {}
    for name, eager in (("graph_wall", False), ("eager_wall", True)):
        kv.decode(eager=eager)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            kv.decode(eager=eager)
        walls[name] = (time.perf_counter() - t0) / reps * 1e3
    set_slot_state(kv, saved)
    return {"graph_device": graph_dev, **walls, "replay_profile": profile,
            "eager_ops": ops}


def eager_op_profile(kv, top: int = 10) -> list:
    """``torch.profiler`` over one eager decode step: the device time its
    kernels took, by the PyTorch operator that launched them (self time),
    largest first. The same kernels as a replay, named by operator."""
    from torch.profiler import ProfilerActivity, profile
    kv.decode(eager=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kv.decode(eager=True)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    return [{"op": k, "ms": t / 1e3, "calls": c} for t, k, c in rows[:top]]


def replay_profile(kv, reps: int = 3) -> dict:
    """``torch.profiler`` over ``reps`` replays of the decode graph: the
    kernels a replay runs (CUPTI may drop a few of a graph's records) and
    their device time, with the largest entries."""
    from torch.profiler import ProfilerActivity, profile
    kv._graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kv._graph.replay()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    total = sum(t for t, _, _ in rows)
    return {"kernels_per_replay": sum(c for _, _, c in rows) / reps,
            "device_ms_per_replay": total / 1e3 / reps,
            "top": [{"name": k[:80], "ms": t / 1e3 / reps, "calls": c / reps}
                    for t, k, c in rows[:8]]}


def decode_bound_ms(model, kv) -> tuple:
    """(bound ms, weight bytes, live KV and state bytes) of one decode step
    from the current slot state: the weights read once, each active slot's
    KV up to its cursor read once, the SSM states read and written, the
    logits written, over the card's memory rate."""
    weights = sum(p.numel() * p.element_size() for p in model.params())
    leaves = ([(t, 0) for e in kv.cache["prefix"] for t in e]
              + [(t, 1) for e in kv.cache["blocks"] for t in e])
    per_pos, state = 0, 0
    for t, lead in leaves:
        if t.shape[lead + 1] == kv.max_seq:      # (.., B, S, ..): by position
            per_pos += t.numel() // (kv.max_batch * kv.max_seq) * t.element_size()
        else:                                    # SSM conv and SSD state
            state += 2 * t.numel() * t.element_size()
    positions = int(((kv.cache["t"] + 1) * kv.active).sum())
    live = positions * per_pos + state + kv.logits.numel() * 4
    return (weights + live) / MEM_BYTES_PER_S * 1e3, weights, live


def prefill_ms(kv, lengths, reps: int = 3) -> dict:
    """Host wall of a B=1 prefill (to its first token), median of reps."""
    out = {}
    rng = np.random.RandomState(5)
    for n in lengths:
        p = rng.randint(0, kv.model.cfg.vocab_size, size=n).astype(np.int32)
        kv.prefill(p)
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kv.prefill(p)
            ts.append((time.perf_counter() - t0) * 1e3)
        out[str(n)] = float(np.median(ts))
    return out


def count_moe_drops(kv) -> dict:
    """(token, expert) pairs dropped by capacity in one eager decode step
    from the current slot state (the state is restored): the router's
    choices recorded per MoE layer, then the reference's slot positions
    (an exclusive cumsum, token-major) against C."""
    from repro_torch.models import moe as M
    cfg = kv.model.cfg
    seen, router = [], M._router

    def recording(p, x, k):
        out = router(p, x, k)
        seen.append(out[2])
        return out
    saved = slot_state(kv)
    M._router = recording
    try:
        kv.decode(eager=True)
    finally:
        M._router = router
    set_slot_state(kv, saved)
    B = kv.max_batch
    C = M._capacity(B, cfg.top_k, cfg.num_experts, cfg.moe_capacity_factor)
    dropped = 0
    for idx in seen:
        flat = M._one_hot(idx, cfg.num_experts, torch.int32).reshape(
            B * cfg.top_k, cfg.num_experts)
        pos = ((torch.cumsum(flat, 0) - flat) * flat).sum(-1)
        dropped += int((pos >= C).sum())
    return {"moe_layers": len(seen), "capacity": C, "pairs": B * cfg.top_k,
            "dropped_pairs_first_step": dropped}


def serve_summary(res: dict) -> dict:
    from repro_torch.obs.stats import percentile
    comps = res["completions"]
    gaps = [g for c in comps for g in c.token_times[1:]]
    return {"tokens": res["tokens"], "seconds": res["seconds"],
            "tokens_per_s": res["tokens"] / res["seconds"],
            "token_gap_ms_p50": percentile(gaps, 50) * 1e3,
            "token_gap_ms_p95": percentile(gaps, 95) * 1e3,
            "warmup_seconds": res["warmup_seconds"],
            "compile_counts": res["scheduler"].kv.compile_counts()}


def serve_checks(model_name: str, res: dict, *, oneshot: bool,
                 drops: bool) -> dict:
    """The checks of a continuous run of the serve launcher: one capture;
    graph replay against eager decode, bit for bit, from a state with
    every slot filled; with ``oneshot`` the run's tokens against the
    one-shot path under the margin rule; with ``drops`` the MoE capacity
    drops of the first decode step of that state."""
    from repro_torch.launch.serve import workload, parse_args
    model, kv = res["model"], res["scheduler"].kv
    args = parse_args(serve_args(model_name, SERVE_ZOO_RUN))
    out = serve_summary(res)
    reqs = workload(args, model.cfg.vocab_size)
    if oneshot:
        out["against_oneshot"] = against_oneshot(
            res["completions"], oneshot_reference(model, reqs, kv.max_seq),
            margin_tol())
    fill_slots(kv, reqs)
    if drops:
        out["moe"] = count_moe_drops(kv)
    out["graph_equals_eager"] = graph_vs_eager(kv)
    out["decode_ms"] = decode_times(kv)
    out["bound_ms"], out["weight_bytes"], out["live_kv_bytes"] = \
        decode_bound_ms(model, kv)
    out["cache_bytes"] = sum(t.numel() * t.element_size() for t in kv.tensors())
    out["captures"] = kv.compile_counts()["decode"]
    for slot in range(kv.max_batch):
        kv.retire(slot)
    return out


def gate_serve(name: str, out: dict) -> None:
    if out["captures"] != 1:
        raise SystemExit(f"{name}: decode graph captured {out['captures']} "
                         f"times, not once")
    if not all(out["graph_equals_eager"]):
        raise SystemExit(f"{name}: graph replay differs from eager decode: "
                         f"{out['graph_equals_eager']}")
    if "against_oneshot" in out and out["against_oneshot"]["diverged"]:
        raise SystemExit(f"{name}: continuous and one-shot diverge where no "
                         f"near-tie excuses it: "
                         f"{out['against_oneshot']['diverged'][:4]}")


def phase_serve():
    """``paper-transformer`` base through the serve launcher's continuous
    engine (48 mixed-length requests on 16 slots of 1024 positions), then
    its checks: one capture, graph against eager bit for bit, the run
    against the one-shot path under the margin rule, and 3 requests'
    prefill and first decode steps against the full forward. Prints
    tokens/s, token gaps, prefill ms by prompt length, decode ms (graph,
    eager), the step's bytes bound, peak memory and cache bytes."""
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.serve import parse_args, workload
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    res = launcher.main(serve_args("transformer", SERVE_RUN))
    model, kv = res["model"], res["scheduler"].kv
    out = serve_summary(res)
    reqs = workload(parse_args(serve_args("transformer", SERVE_RUN)),
                    model.cfg.vocab_size)
    out["against_oneshot"] = against_oneshot(
        res["completions"], oneshot_reference(model, reqs, kv.max_seq),
        margin_tol())
    out["against_full_forward"] = against_full_forward(model, kv, reqs[:3])
    out["prefill_ms"] = prefill_ms(kv, (128, 256, 512))
    fill_slots(kv, reqs)
    for _ in range(8):
        kv.decode()
    out["graph_equals_eager"] = graph_vs_eager(kv)
    out["decode_ms"] = decode_times(kv)
    out["bound_ms"], out["weight_bytes"], out["live_kv_bytes"] = \
        decode_bound_ms(model, kv)
    out["cursors"] = kv.cache["t"].tolist()
    out["cache_bytes"] = sum(t.numel() * t.element_size() for t in kv.tensors())
    out["captures"] = kv.compile_counts()["decode"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["params"] = sum(p.numel() for p in model.params())
    out["seconds_phase"] = time.perf_counter() - t0
    emit("serve", config=model.cfg.name, **out)
    gate_serve("serve", out)
    worst = max(max(r["prefill"] / SERVE_TOL["prefill"],
                    max(r["decode"]) / SERVE_TOL["decode"])
                for r in out["against_full_forward"])
    if worst > 1.0:
        raise SystemExit(f"serve: cached prefill/decode against the full "
                         f"forward: {out['against_full_forward']}")


def phase_serve_oneshot():
    """The one-shot engine at batch 16, prompt 512, 64 steps: tokens/s."""
    from repro_torch.launch import serve as launcher
    t0 = time.perf_counter()
    res = launcher.main(serve_args("transformer", ONESHOT_RUN))
    out = res["out"]
    emit("serve_oneshot", config=res["model"].cfg.name, batch=16, prompt=512,
         steps=64, tokens=res["tokens"], seconds=res["seconds"],
         tokens_per_s=res["tokens"] / res["seconds"],
         warmup_seconds=res["warmup_seconds"], shape=list(out.shape),
         seconds_phase=time.perf_counter() - t0)
    if out.shape != (16, 512 + 64):
        raise SystemExit(f"serve_oneshot: output shape {out.shape}")


def phase_serve_zoo(model: str):
    """``paper-ssm`` or ``paper-moe`` base, continuous, 16 requests: graph
    against eager bit for bit; the SSM also against the one-shot path
    under the margin rule; the MoE's capacity drops at the first decode
    step (its tokens depend on the co-batched slots, so no one-shot
    comparison)."""
    from repro_torch.launch import serve as launcher
    t0 = time.perf_counter()
    res = launcher.main(serve_args(model, SERVE_ZOO_RUN))
    out = serve_checks(model, res, oneshot=model == "ssm",
                       drops=model == "moe")
    out["seconds_phase"] = time.perf_counter() - t0
    emit(f"serve_{model}", config=res["model"].cfg.name, **out)
    gate_serve(f"serve_{model}", out)


def phase_serve_arch():
    """Each reduced architecture in bf16: prefill and 8 decode steps
    against the full forward (relative in norm, SERVE_TOL), and a cursor
    vector against a scalar cursor; whisper (enc-dec) and InternVL2 (VLM)
    through the one-shot engine only (their tokens from ``generate``)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine, merge_prefill_cache
    from repro_torch.models.api import frontend_embeds
    from repro_torch.serve.slots import UNSERVABLE_FAMILIES
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        m = build_model(cfg, kernels="cuda", param_dtype=torch.bfloat16,
                        device=DEV)
        m.init(0, max_seq=64)
        B = 2
        Sp = cfg.num_image_tokens + 4 if cfg.family == "vlm" else 8
        S = Sp + 8
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(B, S))).to(DEV)
        fe = frontend_embeds(cfg, B, DEV)
        batch = {"tokens": tokens[:, :Sp]}
        if fe is not None:
            batch["frontend_embeds"] = fe
        with torch.no_grad():
            h, _ = T.forward(m.module, tokens, fe, remat=False)
            full = T.logits_head(m.module, h)
        logits, pre = m.prefill_fn(batch)
        errs = {"prefill": rel_norm(logits, full[:, Sp - 1]), "decode": []}
        cache = merge_prefill_cache(m.init_cache(B, S), pre)
        cache["t"] = Sp
        for t in range(Sp, S):
            logits, cache = m.decode_fn(cache, tokens[:, t:t + 1])
            errs["decode"].append(rel_norm(logits, full[:, t]))
        out = {"arch": arch, "family": cfg.family, "errors": errs}
        if cfg.family in UNSERVABLE_FAMILIES:
            gen = ServeEngine(m, max_seq=S).generate(
                tokens[:, :Sp].cpu().numpy(), steps=4)
            out["engine"] = "oneshot"
            out["generated"] = gen[:, Sp:].tolist()
        else:
            def decode_with(t):
                c = merge_prefill_cache(m.init_cache(B, S), pre)
                c["t"] = t
                return m.decode_fn(c, tokens[:, Sp:Sp + 1])[0]
            vec = torch.full((B,), Sp, dtype=torch.int64, device=DEV)
            out["engine"] = "oneshot+slots"
            out["vector_vs_scalar"] = rel_norm(decode_with(vec),
                                               decode_with(Sp))
        out["seconds"] = time.perf_counter() - t0
        emit("serve_arch", config=cfg.name, **out)
        if (errs["prefill"] > SERVE_TOL["prefill"]
                or max(errs["decode"]) > SERVE_TOL["decode"]
                or out.get("vector_vs_scalar", 0.0) > SERVE_TOL["decode"]):
            raise SystemExit(f"serve_arch {arch}: {out}")


def phase_train_and_serve():
    """A trainer child (``paper-transformer`` base, the launcher through
    ``--launch``) publishing at step 4 of 4 while this process serves
    with the watcher polled before every decode step: at least 2
    generations served, no request dropped, a request that spans a swap,
    and the served params equal to the file LATEST points to, by checksum.
    Prints each swap's snapshot load seconds and decode stall."""
    import tempfile

    from repro_torch.models import build_model
    from repro_torch.obs import MemorySink, MetricsRecorder
    from repro_torch.serve import (ContinuousScheduler, Request,
                                   SnapshotWatcher, read_pointer)
    from repro_torch.serve.snapshot import params_checksum
    from repro_torch.train.checkpoints import layout_for
    t0 = time.perf_counter()
    cfg = zoo_base("transformer")
    m = build_model(cfg, kernels="cuda", param_dtype=torch.bfloat16,
                    device=DEV)
    m.init(0, max_seq=1024)
    layout = layout_for(m.module)
    sink = MemorySink()
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory(prefix="publish_", dir=ROOT) as d:
        pub = os.path.join(d, "pub")
        watcher = SnapshotWatcher(pub, m.params(), layout=layout,
                                  recorder=MetricsRecorder([sink]))
        snaps, poll = [], watcher.poll

        def recording_poll():
            snap = poll()
            if snap is not None:
                snaps.append((snap.path, snap.params_checksum))
            return snap
        watcher.poll = recording_poll
        sched = ContinuousScheduler(m, max_batch=16, max_seq=1024,
                                    watcher=watcher, swap_poll_every=1)
        rid = 0

        def feed_and_step():
            nonlocal rid
            while sched.pending < 16:
                p = rng.randint(0, cfg.vocab_size, size=64).astype(np.int32)
                sched.submit(Request(rid=rid, prompt=p, max_new_tokens=16))
                rid += 1
            sched.step()

        while len(sched.completions) < 16:     # generation 0 first
            feed_and_step()
        child = subprocess.Popen(
            child_cmd(os.path.join(d, "train.json"), {},
                      train_args("transformer", PUBLISH_STEPS)
                      + ["--publish-dir", pub, "--publish-every",
                         str(PUBLISH_EVERY)]))
        try:
            deadline = time.perf_counter() + 600
            while child.poll() is None and time.perf_counter() < deadline:
                feed_and_step()
            child.wait(timeout=60)
            sched.poll_snapshot()              # the final snapshot
            while sched.pending:
                sched.step()
        finally:
            child.kill()
        final, snap_checksum = snaps[-1] if snaps else ("", None)
        pointer = read_pointer(pub)
        served = params_checksum(m.params(), layout)
    comps = sched.completions
    gens = sorted({c.gen_finished for c in comps})
    loads = {e["data"]["generation"]: e["data"]["seconds"]
             for e in sink.by_name("serve.snapshot_load")}
    swaps = [{"step": e.step, "generation": e.generation,
              "trainer_step": e.trainer_step,
              "snapshot_load_seconds": loads.get(e.generation),
              "decode_stall_seconds": e.load_seconds}
             for e in sched.swap_events]
    last_snap = sched.swap_events[-1] if sched.swap_events else None
    out = dict(config=cfg.name, trainer_steps=PUBLISH_STEPS,
               publish_every=PUBLISH_EVERY, child_rc=child.returncode,
               requests=rid, completions=len(comps), generations=gens,
               swaps=swaps,
               spanning=sum(c.gen_admitted != c.gen_finished for c in comps),
               all_full=all(len(c.tokens) == 16 for c in comps),
               final_snapshot=os.path.basename(final),
               pointer=os.path.basename(pointer or ""),
               served_checksum=served,
               snapshot_checksum=snap_checksum,
               compile_counts=sched.kv.compile_counts(),
               seconds=time.perf_counter() - t0)
    emit("train_and_serve", **out)
    if child.returncode != 0:
        raise SystemExit(f"train_and_serve: trainer exited {child.returncode}")
    if len(gens) < 2 or last_snap is None:
        raise SystemExit(f"train_and_serve: generations served {gens}")
    if sorted(c.rid for c in comps) != list(range(rid)) or not out["all_full"]:
        raise SystemExit("train_and_serve: a request was dropped or cut")
    if not out["spanning"]:
        raise SystemExit("train_and_serve: no request spans a swap")
    if out["final_snapshot"] != out["pointer"] or \
            served != out["snapshot_checksum"]:
        raise SystemExit("train_and_serve: served params differ from the "
                         "file LATEST points to")
    if out["compile_counts"]["decode"] != 1:
        raise SystemExit(f"train_and_serve: {out['compile_counts']}")


ANALYSIS_PEAK_BAND = (0.9, 1.1)           # card peak / meta peak, stated before the run
ANALYSIS_STOP = 5                         # Alg. 2 trips: the dry-run's --isgd-stop


def phase_analysis(per_step: dict) -> dict:
    """The analysis tier (``repro_torch.analysis``) held against the card:
    one ISGD train step of ``paper-transformer`` base at the ``train``
    run's batch shape (8 × 1024), made by the dry-run's own builder
    (``launch.dryrun.build_step``: the hybrid engine's device-form step,
    parameters placed by ``hybrid_params_placement``) at mesh (data=1,
    model=1) over a one-rank NCCL group, and run in analysis mode: the
    accelerate branch and exactly ``ANALYSIS_STOP`` Alg. 2 trips, masked.
    The builder makes the step twice, on meta tensors and on the card.
    ``dryrun.count_step`` counts the meta one, as the CLI does; the card
    runs the other:

      (a) the meta count's aten FLOPs (the kernels' ``cost()`` set aside)
          equal ``FlopCounterMode``'s count of the step on the card, which
          cannot see the ctypes kernels;
      (b) the meta count's kernel launches equal the device counters and
          (1 + stop) × the evaluation's (1 ``fused_xent``, 32
          ``flash_attention``);
      (c) the step's device time (its kernels' time from
          ``torch.profiler``) is at least the roofline's ``compute_s`` (no
          card beats its peak); its ratio to max(compute_s, memory_s) is
          printed, not gated (the bytes are eager and unfused, and the
          50 MB L2 holds much of them);
      (d) the meta peak (the argument bytes, the engine's buffers and the
          step's live-bytes peak) against the card's
          ``max_memory_allocated`` of the step, within
          ``ANALYSIS_PEAK_BAND``; the argument bytes against what the card
          holds before the step.

    The one-rank reduction links no card: the count records no collective,
    which is checked too. Raises on any failure."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis import analysis_mode, roofline
    from repro_torch.configs import InputShape, zoo_config
    from repro_torch.kernels import launch_count
    from repro_torch.launch import dryrun, env
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg = zoo_config("transformer", "base")
    shape = InputShape("smoke_8x1024", 1024, 8, "train")
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(shape.global_batch, shape.seq_len)
    ).astype(np.int32)
    per_eval = {k: per_step["per_eval"][k] for k in DEVICE_KERNELS}
    expect = {k: (1 + ANALYSIS_STOP) * n for k, n in per_eval.items()}

    with env.local_group("cuda", "nccl"):
        mesh = make_host_mesh(1, device="cuda", backend="nccl")
        mesh_name = dryrun._mesh_name(mesh)
        meta = dryrun.build_step(build_model(cfg, kernels="cuda",
                                             device="meta"),
                                 mesh, shape, isgd_stop=ANALYSIS_STOP)
        c, t_count = dryrun.count_step(meta)
        del meta
        predicted = {k: c.launches.get(k, 0) for k in DEVICE_KERNELS}

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        card = dryrun.build_step(
            build_model(cfg, kernels="cuda", device="cuda"), mesh, shape,
            isgd_stop=ANALYSIS_STOP,
            batch={"tokens": torch.from_numpy(tokens).cuda()})
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base

        def step():
            with analysis_mode():
                card.run()

        step()                                       # warm (cuBLAS, loads)
        torch.cuda.synchronize()
        with FlopCounterMode(display=False) as fcm:
            step()
        card_flops = fcm.get_total_flops()
        launch_count.enable("cuda", DEVICE_KERNELS)
        step()
        torch.cuda.synchronize()
        device_launches = launch_count.read()
        launch_count.disable()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        card_peak = torch.cuda.max_memory_allocated() - base
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        ms = sum(r[0] for r in device_rows(prof)) / 1e3
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        wall_ms = a.elapsed_time(b)
        del card, step
    torch.cuda.empty_cache()

    rl = roofline.analyze(c, arch=cfg.name, shape=shape.name,
                          mesh_name=mesh_name, chips=1,
                          model_flops_per_device=roofline.model_flops(
                              cfg, shape, 1))
    compute_ms, memory_ms = rl.compute_s * 1e3, rl.memory_s * 1e3
    meta_peak = c.arg_bytes + c.buffer_bytes + c.temp_peak
    res = {
        "model": cfg.name, "batch": [shape.global_batch, shape.seq_len],
        "mesh": mesh_name, "backend": "nccl", "isgd_stop": ANALYSIS_STOP,
        "hw": roofline.H100_SXM["name"],
        "meta_count_s": t_count, "seconds": time.perf_counter() - t0,
        "aten_flops_meta": c.aten_flops, "aten_flops_card": card_flops,
        "kernel_flops_meta": c.kernel_flops,
        "elementwise_flops_meta": c.elementwise_flops,
        "flops_by_dtype_meta": dict(c.flops_by_dtype),
        "bytes_meta": c.bytes, "collectives_meta": len(c.collectives),
        "launches_meta": predicted, "launches_expected": expect,
        "launches_card": {k: device_launches.get(k, 0) for k in predicted},
        "ms_card": ms, "event_ms_card": wall_ms,
        "compute_ms": compute_ms, "memory_ms": memory_ms,
        "ms_over_compute": ms / compute_ms,
        "ms_over_roofline": ms / max(compute_ms, memory_ms),
        "arg_bytes_meta": c.arg_bytes, "buffer_bytes_meta": c.buffer_bytes,
        "held_bytes_card": held, "held_before_step_card": before - base,
        "temp_peak_meta": c.temp_peak,
        "peak_bytes_meta": meta_peak, "peak_bytes_card": card_peak,
        "peak_card_over_meta": card_peak / meta_peak,
        "peak_band": list(ANALYSIS_PEAK_BAND),
    }
    emit("analysis", **res)
    if card_flops != c.aten_flops:
        raise SystemExit(f"analysis (a): meta aten FLOPs {c.aten_flops} != "
                         f"the card's FlopCounterMode {card_flops}")
    if not (res["launches_card"] == predicted == expect):
        raise SystemExit(f"analysis (b): launches predicted {predicted}, "
                         f"(1 + stop) × an evaluation's {expect}, counted "
                         f"on the card {res['launches_card']}")
    if ms < compute_ms:
        raise SystemExit(f"analysis (c): the card took {ms} ms, below the "
                         f"roofline's compute time {compute_ms} ms")
    lo, hi = ANALYSIS_PEAK_BAND
    if not lo <= res["peak_card_over_meta"] <= hi:
        raise SystemExit(f"analysis (d): card peak {card_peak} against the "
                         f"meta peak {meta_peak}, outside {ANALYSIS_PEAK_BAND}")
    if c.collectives:
        raise SystemExit(f"analysis: a one-rank mesh recorded "
                         f"{len(c.collectives)} collectives")
    return res


def async_phases(per_step: dict) -> dict:
    """The async parameter-server phases -> ``async_ps``'s device
    launches."""
    ref = phase_async_ps(per_step)
    phase_async_ps2(per_step)
    phase_async_resume(ref)
    launches = ref["device_launches"]
    del ref
    phase_async_faults()
    run_legs(async_parity_legs())
    return launches


CHILD_JOBS = 4                             # child phases at a time (card memory)


def child_phases(sched_ref: dict, async_ref: dict, per_step: dict,
                 chunked: dict) -> dict:
    """The phases whose runs are child processes of the launcher or of a
    harness (``hybrid_moe``, ``hybrid_gqa``, ``resume``, ``async_resume``,
    ``dp``, ``dp2``, ``hybrid`` and the parity legs), each in a thread of
    its own,
    CHILD_JOBS at a time, longest first: their checks are bit for bit or
    within a tolerance,
    and none is timed against a bound. ``async_parity`` is not among them:
    its two-worker leg's convergence depends on how the threads of one
    process interleave, and on a shared host it failed its ψ̄ tolerance
    (1.651 against 1.371, tolerance 0.25). All six at once ask more than
    the card's 80 GB (about 15 GB for ``dp2``'s two ranks, 10 for each
    other phase, 11 this process holds), so CHILD_JOBS bounds them. Their
    walls and s/step include the others' share of the card and the host.
    Every phase runs to its end; then any failure raises.
    The line ``child_phases`` gives their wall and what this process
    still holds on the card. -> ``hybrid``'s, ``hybrid_gqa``'s and
    ``hybrid_moe``'s rank-0 device launches, by phase."""
    from concurrent.futures import ThreadPoolExecutor
    torch.cuda.empty_cache()                # the children's room
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    jobs = {"hybrid_moe": phase_hybrid_moe,
            "hybrid_gqa": phase_hybrid_gqa,
            "resume": partial(phase_resume, sched_ref),
            "async_resume": partial(phase_async_resume, async_ref),
            "parity": partial(run_legs, dp_parity_legs()
                              + hybrid_parity_legs()
                              + multihost_parity_legs() + zoo_parity_legs()),
            "dp": partial(phase_dp, per_step, chunked),
            "dp2": partial(phase_dp2, per_step),
            "hybrid": partial(phase_hybrid, per_step)}
    with ThreadPoolExecutor(CHILD_JOBS) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
    failures = [f"{name}: {f.exception()}" for name, f in futures.items()
                if f.exception() is not None]
    emit("child_phases", jobs=list(jobs), at_a_time=CHILD_JOBS,
         failed=[f.split(":")[0] for f in failures],
         main_allocated_gib=held[0] / 2**30, main_reserved_gib=held[1] / 2**30,
         seconds=time.perf_counter() - t0)
    if failures:
        raise SystemExit("\n".join(failures))
    return {name: futures[name].result()
            for name in ("hybrid", "hybrid_gqa", "hybrid_moe")}


def serve_phases():
    phase_serve()
    phase_serve_oneshot()
    for model in ("ssm", "moe"):
        phase_serve_zoo(model)
    phase_serve_arch()
    phase_train_and_serve()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    if sys.argv[1:2] == ["--launch"]:
        return launch_child(sys.argv[2], json.loads(sys.argv[3]),
                            sys.argv[4:])
    if sys.argv[1:2] == ["--profile-chunked"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return profile_chunked_child(sys.argv[2], json.loads(sys.argv[3]))
    if sys.argv[1:2] == ["--serve-only"]:
        phase_device()
        return serve_phases()
    if sys.argv[1:2] == ["--async-only"]:
        phase_device()
        phase_build()
        return async_phases(phase_train("transformer"))
    if sys.argv[1:2] == ["--tp-only"]:
        phase_device()
        phase_build()
        for dtype in (torch.float32, torch.bfloat16):
            check_gqa_shapes(dtype)
            check_moe_shapes(dtype)
        phase_hybrid(phase_train("transformer"))
        phase_hybrid_gqa()
        return phase_hybrid_moe()
    if sys.argv[1:2] == ["--analysis-only"]:
        phase_device()
        phase_build()
        return phase_analysis(phase_train("transformer"))
    smi = phase_device()
    phase_build()
    main_checks = phase_checks()
    train, chunked = {}, {}
    for model in MODELS:
        train[model] = phase_train(model)
        phase_parity(model, train[model]["step1_loss"])
        phase_profile(model, main_checks)
        chunked[model] = phase_chunked(model, train[model])
        ms = chunked[model]["ms_per_step_after_first_chunk"]
        if model == "transformer":
            phase_chunked(model, train[model], k=1)
        phase_profile_chunked(model, train[model]["per_eval"], ms)
    phase_arch_reduced()
    phase_chunked_arch()
    cnn = phase_train_cnn()
    phase_profile_chunked("cnn", dict.fromkeys(DEVICE_KERNELS, 0),
                          phase_chunked_cnn(cnn))
    phase_obs()
    phase_micro_batches()
    phase_profile_dir()
    phase_eval_cnn()
    sched_ref = phase_sched(train["transformer"], chunked["transformer"])
    async_ref = phase_async_ps(train["transformer"])
    phase_async_ps2(train["transformer"])
    hybrid = child_phases(sched_ref, async_ref, train["transformer"],
                          chunked["transformer"])
    async_launches = async_ref["device_launches"]
    del sched_ref, async_ref
    phase_async_faults()
    run_legs(async_parity_legs())
    phase_analysis(train["transformer"])
    serve_phases()
    kernels = []
    for name, path, replaces in (
            ("fused_xent", "transformer",
             "src/repro/kernels/fused_xent/kernel.py:26"),
            ("flash_attention", "transformer",
             "src/repro/kernels/flash_attention/kernel.py:24"),
            ("ssd_scan", "ssm", "src/repro/kernels/ssd_scan/kernel.py:23")):
        r = main_checks[name]
        kernels.append({"name": name, "route": "cuda", "path": path,
                        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                        "replaces": replaces, "design": DESIGN[name],
                        "launches": train[path]["launches"][name],
                        "launches_by_path": dict(
                            {m: train[m]["launches"][name] for m in MODELS},
                            hybrid_rank0=hybrid["hybrid"].get(name, 0),
                            hybrid_gqa_rank0=hybrid["hybrid_gqa"].get(name, 0),
                            **{f"hybrid_moe_{mode}_rank0": n.get(name, 0)
                               for mode, n in hybrid["hybrid_moe"].items()},
                            async_ps=async_launches.get(name, 0)),
                        "max_abs_err": r["max_abs"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "achieved_tflops": r["achieved_tflops"],
                        "bound_share": r["bound_share"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
