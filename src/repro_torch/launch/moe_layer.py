"""Where an MoE layer's device time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.moe_layer [--reps 30]

One ``paper-moe`` (base) MoE layer, 8 × 1024 tokens of width 768, 8
experts top-2 of ff 1536, capacity factor 1.25, bf16, weights drawn as the
model's init draws them: its forward and backward (the gradients of the
input and of every weight), beside the path's dense SwiGLU MLP (d_ff 3072)
on the same input. Each step is captured into a CUDA graph and timed by
CUDA events around ``--reps`` replays (the eager MoE step's host work
outlasts its device work, so eager timing would measure the host); then
one eager call of each is profiled and its device time split into matrix
products (GEMM kernels) and the rest (the router's softmax and top-k, the
one-hot dispatch and combine tensors, the autograd glue). Prints one JSON
line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
import re

import torch

GEMM_NAMES = re.compile(r"gemm|nvjet|cutlass|xmma")   # matrix-product kernels
TOKENS = (8, 1024)


def graph_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn``: its kernels captured into a CUDA
    graph (after a warm-up on a side stream), replayed ``reps`` times
    between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_split(fn) -> dict:
    """One profiled call of ``fn``: device ms in all, in matrix products,
    and the kernel count."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"profiled_ms": sum(t for t, _, _ in rows) / 1e3,
            "products_ms": sum(t for t, k, _ in rows if GEMM_NAMES.search(k)) / 1e3,
            "kernels": sum(c for _, _, c in rows)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("moe_layer needs a CUDA device; none is available")
    from repro_torch.configs import zoo_config
    from repro_torch.models import layers as L
    from repro_torch.models.moe import init_moe, moe_forward
    cfg = zoo_config("moe", "base")
    d, ff = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(shape, dtype=torch.bfloat16):
        w = torch.randn(shape, generator=gen, device="cuda") / math.sqrt(shape[-2])
        return w.to(dtype).requires_grad_(True)

    moe = {k: draw(w.shape, w.dtype)
           for k, w in init_moe(cfg, torch.bfloat16, "cuda").items()}
    dense = {"wg": draw((d, ff)), "wi": draw((d, ff)), "wo": draw((ff, d))}
    x = draw((*TOKENS, d))
    gy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)

    def moe_step():
        y, aux = moe_forward(moe, cfg, x)
        torch.autograd.grad((y, aux), [x, *moe.values()],
                            (gy, torch.ones_like(aux)))

    def dense_step():
        torch.autograd.grad(L.mlp(dense, x), [x, *dense.values()], gy)

    out = {"config": cfg.name, "tokens": TOKENS[0] * TOKENS[1],
           "device": torch.cuda.get_device_name(0)}
    for name, fn in (("moe", moe_step), ("dense_mlp", dense_step)):
        out[name + "_ms"] = graph_ms(fn, args.reps)
        out.update({f"{name}_{k}": v for k, v in device_split(fn).items()})
    out["moe_products_share"] = out["moe_products_ms"] / out["moe_profiled_ms"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
