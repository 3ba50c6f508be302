#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc``, holds each kernel against its plain
PyTorch version on the card, trains ``paper-transformer`` (base tier, full
width) for 12 ISGD steps through the launcher with ``--kernels cuda``, and
checks that the training path really launched the kernels. Each phase
prints one JSON line; the last two lines are the kernels summary and
``{"ok": true, "device": {...}}``.

Nothing is caught: any failure exits nonzero before the last line. Without
a CUDA device, or outside a checkout of the repository, it exits nonzero
and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
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

# the training run below: --batch 8 --seq 1024 on the base tier
TRAIN_ARGS = ["--model", "transformer", "--tier", "base", "--kernels", "cuda",
              "--precision", "bf16", "--batch", "8", "--seq", "1024",
              "--n-seqs", "32", "--steps", "12", "--k-sigma", "1.0",
              "--stop", "3", "--device", "cuda"]
XENT_MAIN = (8192, 1024, 32768, 32768)     # N = B·S, d, Vp, vocab
ATTN_MAIN = (8, 1024, 16, 8, 64)           # B, S, H, K, hd (causal)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in libs:
        build.load(name)
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()})


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
    emit("check", **res)
    if not res["ok"]:
        raise SystemExit(f"flash_attention disagrees with its plain version: {res}")
    return res


def phase_checks() -> dict:
    """Every kernel vs its plain version, f32 and bf16: the main path's
    shapes (timed), the ragged grid cells of the CPU tests and the tiny
    tier. -> {kernel: the timed bf16 main-shape result}."""
    from repro_torch.kernels.numerics import ATTN_SHAPES, XENT_SHAPES, gqa_split
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        main["fused_xent"] = check_xent(XENT_MAIN, dtype, timed=True)
        for shape in XENT_SHAPES:
            check_xent(shape, dtype)
        check_xent((1024, 64, 256, 256), dtype, tied=True)   # tiny tier's head
        main["flash_attention"] = check_attn(ATTN_MAIN, dtype, timed=True)
        for BH, S, hd, causal, window in ATTN_SHAPES:
            B, H, K = gqa_split(BH)
            check_attn((B, S, H, K, hd), dtype, causal=causal, window=window)
        check_attn((2, 256, 8, 2, 128), dtype)                # hd = 128
        check_attn((8, 128, 4, 2, 16), dtype)                 # tiny tier
    return main                    # the bf16 entries: the training dtype


def phase_train() -> dict:
    from repro_torch.configs import zoo_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_xent import fused_xent
    from repro_torch.launch import train as launcher
    fused_xent.launches = 0
    flash_attention.launches = 0
    res = launcher.main(TRAIN_ARGS)
    launches = {"fused_xent": fused_xent.launches,
                "flash_attention": flash_attention.launches}
    log, state = res["log"], res["state"]
    steps = res["steps"]
    cfg = zoo_config("transformer", "base")
    # one loss-and-gradient per step plus one per Alg.2 trip; ψ launches
    # fused_xent once per evaluation, and under remat every layer's
    # attention runs twice (forward and the backward's recomputation)
    evals = steps + state.sub_iters
    expect = {"fused_xent": evals, "flash_attention": 2 * cfg.num_layers * evals}
    emit("train", config=cfg.name, params=res["params"], steps=steps,
         losses=log.losses, accelerated=state.accel_count,
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


def phase_parity(train_step1: float):
    """Step 1's loss through the kernels and through the model's plain
    paths, from the same init on the same batch."""
    from repro_torch.configs import zoo_config
    from repro_torch.data import FCPRSampler, make_lm_tokens
    from repro_torch.kernels.numerics import TOLERANCES
    from repro_torch.models import build_model
    cfg = zoo_config("transformer", "base")
    data = make_lm_tokens(0, 32, 1024, cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(
        FCPRSampler(data, batch_size=8, seed=1)(0)["tokens"]).cuda()}
    loss = {}
    for kernels in ("cuda", "reference"):
        model = build_model(cfg, kernels=kernels, param_dtype=torch.bfloat16,
                            device="cuda")
        model.init(0)
        with torch.no_grad():
            loss[kernels] = float(model.loss_fn(batch)[0])
        del model
    rtol = TOLERANCES["fused_xent"]["bfloat16"][0]
    rel = abs(loss["cuda"] - loss["reference"]) / abs(loss["reference"])
    rel_train = abs(train_step1 - loss["cuda"]) / abs(loss["cuda"])
    emit("parity", loss_cuda=loss["cuda"], loss_reference=loss["reference"],
         rel=rel, train_step1=train_step1, rel_train=rel_train, rtol=rtol)
    if not (rel <= rtol and rel_train <= rtol):
        raise SystemExit("step-1 loss: kernels and plain paths disagree")


def phase_profile():
    """Device time by kernel over three training steps of the main path
    (a fresh launcher run), from torch.profiler's CUDA events; the busy
    share is that time over the launcher's own step clock."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as launcher
    args = TRAIN_ARGS[:]
    args[args.index("--steps") + 1] = "3"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = launcher.main(args)
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    emit("profile", steps=3, step_window_s=res["seconds"], device_busy_s=busy,
         busy_share=busy / res["seconds"],
         top=[{"name": k[:90], "ms_per_step": t / 1e3 / 3, "calls": c,
               "share": t / 1e6 / busy} for t, k, c in rows[:15]])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    smi = phase_device()
    phase_build()
    main_checks = phase_checks()
    train = phase_train()
    phase_parity(train["step1_loss"])
    phase_profile()
    kernels = []
    for name, source, replaces in (
            ("fused_xent", "src/repro_torch/kernels/csrc/fused_xent.cu",
             "src/repro/kernels/fused_xent/kernel.py:26"),
            ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:24")):
        r = main_checks[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": train["launches"][name],
                        "max_abs_err": r["max_abs"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
