#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` and shows from ptxas and the SASS how each
was compiled (``wgmma`` and TMA in the bf16 routes of all three), holds
each kernel against its plain PyTorch version on the card, times kernel,
plain version and library call by device time
(``cuda_ms``), and drives the port's two training paths
through the launcher with ``--kernels cuda``: ``paper-transformer`` (base
tier, 16 layers) and ``paper-ssm`` (base tier, 24 Mamba2/SSD layers), both
at full width for 12 ISGD steps. For each path it checks that the run
really launched that path's kernels, compares step 1's loss with the
model's plain paths, and profiles three steps. Each phase prints one JSON
line; the last two lines are the kernels summary and ``{"ok": true,
"device": {...}}``.

Nothing is caught: any failure exits nonzero before the last line. Without
a CUDA device, or outside a checkout of the repository, it exits nonzero
and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

MEM_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense tensor-core bf16
              torch.float32: 67e12}        # f32 outside the tensor cores
DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

MODELS = ("transformer", "ssm")            # the training paths, in order
SUFFIX = {"transformer": "", "ssm": "_ssm"}  # of each path's phase names
XENT_MAIN = (8192, 1024, 32768, 32768)     # N = B·S, d, Vp, vocab
ATTN_MAIN = (8, 1024, 16, 8, 64)           # B, S, H, K, hd (causal)
SSD_MAIN = (8, 1024, 32, 64, 1, 128, 256)  # b, S, nh, hd, G, ds, chunk
SSD_MAMBA2 = (1, 2048, 80, 64, 1, 128, 256)  # Mamba2-2.7B's mixer
DT_INIT = math.log(math.expm1(0.01))       # dt_bias at init: dt ≈ 0.01–0.02
PARITY_TIGHT = 1e-3                        # step-1 loss, relative


def train_args(model: str, steps: int = 12) -> list:
    """The training run: --batch 8 --seq 1024 on the base tier."""
    return ["--model", model, "--tier", "base", "--kernels", "cuda",
            "--precision", "bf16", "--batch", "8", "--seq", "1024",
            "--n-seqs", "32", "--steps", str(steps), "--k-sigma", "1.0",
            "--stop", "3", "--device", "cuda"]


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def live_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps, per (batch, head)."""
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    keep = np.ones((S, S), bool)
    if causal:
        keep &= k <= q
    if window is not None:
        keep &= k > q - window
    return int(keep.sum())


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
          "ssd_scan": "wgmma+tma"}
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
        y64 = y.long()
        ops = 2.0 * N * d * Vp
        nbytes = (N * d + d * Vp) * h.element_size() + N * 4 + N * 4
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
        ops = 4.0 * B * H * hd * live_pairs(S, causal, window)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
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
        esz = x.element_size()
        # the function's own work, whatever computes it: live (i >= j)
        # pairs of 2(ds + hd) operations (C·Bᵀ counted for every head), then
        # 2·cl·hd·ds for the state, per (chunk, head). The bf16 kernel
        # computes C·Bᵀ once per group, about half of this.
        ops = N * nh * (cl * (cl + 1) / 2 * 2 * (ds + hd) + 2 * cl * hd * ds)
        nbytes = ((N * cl * nh * hd + 2 * N * cl * G * ds) * esz      # x, B, C
                  + (N * cl * nh + nh) * 4                              # dt, A
                  + (N * cl * nh * hd + N * nh * hd * ds + N * nh) * 4)  # outputs
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
    # one loss-and-gradient per step plus one per Alg.2 trip; ψ launches
    # fused_xent once per evaluation, and under remat every layer's mixer
    # kernel runs twice (forward and the backward's recomputation)
    evals = steps + state.sub_iters
    mixer = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    expect = {k: 0 for k in wrappers}
    expect["fused_xent"] = evals
    expect[mixer] = 2 * cfg.num_layers * evals
    emit("train" + SUFFIX[model], config=cfg.name, params=res["params"],
         steps=steps, losses=log.losses, accelerated=state.accel_count,
         sub_iters=state.sub_iters, ms_per_step=res["seconds"] / steps * 1e3,
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
    return {"launches": launches, "step1_loss": log.losses[0]}


def phase_parity(model: str, train_step1: float):
    """Step 1's loss through the kernels and through the model's plain
    paths, from the same init on the same batch: within the bf16 tolerance
    of ``fused_xent`` and within PARITY_TIGHT. At init the loss sits near
    ln V whatever the mixers return, so for the SSM path the first layer's
    mixer output is also held, kernel against plain, at the main shape."""
    from repro_torch.configs import zoo_config
    from repro_torch.data import FCPRSampler, make_lm_tokens
    from repro_torch.kernels.numerics import TOLERANCES
    from repro_torch.models import build_model
    from repro_torch.models.ssm import ssm_forward
    cfg = zoo_config(model, "base")
    data = make_lm_tokens(0, 32, 1024, cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(
        FCPRSampler(data, batch_size=8, seed=1)(0)["tokens"]).cuda()}
    loss = {}
    mixer = None
    for kernels in ("cuda", "reference"):
        m = build_model(cfg, kernels=kernels, param_dtype=torch.bfloat16,
                        device="cuda")
        m.init(0)
        with torch.no_grad():
            loss[kernels] = float(m.loss_fn(batch)[0])
            if cfg.family == "ssm" and kernels == "cuda":
                h = torch.from_numpy(np.random.RandomState(2).randn(
                    8, 1024, cfg.d_model).astype(np.float32)).cuda().to(torch.bfloat16)
                p = m.module.layers[0].mixer
                mixer = compare(ssm_forward(p, cfg, h, use_kernel=True),
                                ssm_forward(p, cfg, h, use_kernel=False),
                                TOLERANCES["ssd_scan"]["bfloat16"])
        del m
    rtol = TOLERANCES["fused_xent"]["bfloat16"][0]
    rel = abs(loss["cuda"] - loss["reference"]) / abs(loss["reference"])
    rel_train = abs(train_step1 - loss["cuda"]) / abs(loss["cuda"])
    emit("parity" + SUFFIX[model], loss_cuda=loss["cuda"], loss_reference=loss["reference"],
         rel=rel, train_step1=train_step1, rel_train=rel_train, rtol=rtol,
         rtol_tight=PARITY_TIGHT, mixer_layer0=mixer)
    if not (rel <= min(rtol, PARITY_TIGHT) and rel_train <= min(rtol, PARITY_TIGHT)):
        raise SystemExit("step-1 loss: kernels and plain paths disagree")
    if mixer is not None and not mixer["ok"]:
        raise SystemExit(f"layer 0's SSM mixer: kernel and plain disagree: {mixer}")


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
                   if e.device_type == torch.autograd.DeviceType.CUDA),
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    smi = phase_device()
    phase_build()
    main_checks = phase_checks()
    train = {}
    for model in MODELS:
        train[model] = phase_train(model)
        phase_parity(model, train[model]["step1_loss"])
        phase_profile(model, main_checks)
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
