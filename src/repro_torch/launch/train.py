"""Training launcher: the single-device per-step ISGD engine.

Port of the per-step engine of ``repro.launch.train`` for the dense
(``--model transformer``) and Mamba2/SSD (``--model ssm``) entries of the
``paper_transformer`` zoo. It builds the model, draws the synthetic LM
token stream (``make_lm_tokens(0, n_seqs, seq, vocab)``) into an FCPR ring
(``seed=1``), and trains through ``repro_torch.train.train``, printing the
JAX launcher's ``step N loss= psi_bar= limit= accel=`` lines and its
``done: ... accelerated= sub_iters=`` line.

The run is on the card unless ``--device cpu`` is given; without a CUDA
device and without that flag it exits nonzero. With ``--kernels cuda`` on
the card the kernels are built before the clock starts.

  PYTHONPATH=src python -m repro_torch.launch.train --model transformer \\
      --tier base --kernels cuda --precision bf16 --batch 8 --seq 1024 \\
      --n-seqs 32 --steps 12 --k-sigma 1.0 --stop 3
  PYTHONPATH=src python -m repro_torch.launch.train --model ssm --tier base \\
      --kernels cuda --precision bf16 --batch 8 --seq 1024 --n-seqs 32 \\
      --steps 12 --k-sigma 1.0 --stop 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --tier tiny \\
      --steps 6 --seq 64 --n-seqs 32 [--model ssm]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ZOO_MODELS, ZOO_TIERS, zoo_config
from repro_torch.core import ISGDConfig, constant_lr
from repro_torch.data import FCPRSampler, make_lm_tokens
from repro_torch.device import resolve_device
from repro_torch.kernels import KERNEL_CHOICES, build
from repro_torch.models import build_model
from repro_torch.optim import RULES
from repro_torch.train import train


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="transformer", choices=list(ZOO_MODELS))
    ap.add_argument("--tier", default="tiny", choices=list(ZOO_TIERS))
    ap.add_argument("--kernels", default="cuda", choices=list(KERNEL_CHOICES),
                    help="cuda: the hand-written kernels (their plain "
                         "versions on a CPU device); reference: the model's "
                         "own plain paths")
    ap.add_argument("--precision", default="bf16", choices=["bf16", "f32"],
                    help="compute dtype for params/activations (psi "
                         "statistics and the SPC queue stay f32)")
    ap.add_argument("--remat", default="full", choices=["full", "none"],
                    help="recompute each layer in the backward pass")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--rule", default="momentum", choices=list(RULES))
    ap.add_argument("--consistent", action="store_true")
    ap.add_argument("--k-sigma", type=float, default=2.0)
    ap.add_argument("--stop", type=int, default=3)
    ap.add_argument("--n-seqs", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when named")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Train as ``args`` say. -> {"log", "state", "seconds", "steps",
    "peak_bytes", "params"}."""
    dev = resolve_device(args.device)
    cfg = zoo_config(args.model, args.tier)
    dtype = torch.float32 if args.precision == "f32" else torch.bfloat16
    model = build_model(cfg, kernels=args.kernels, param_dtype=dtype,
                        remat=args.remat != "none", device=dev)
    model.init(0)
    params = model.params()
    n_params = sum(p.numel() for p in params)
    print(f"arch={cfg.name} engine=per-step device={dev} "
          f"kernels={args.kernels} precision={args.precision} "
          f"remat={args.remat}")
    print(f"params: {n_params/1e6:.1f}M")
    if args.kernels == "cuda" and dev.type == "cuda":
        build.build_all()

    data = make_lm_tokens(0, args.n_seqs, args.seq, cfg.vocab_size)
    sampler = FCPRSampler(data, batch_size=args.batch, seed=1)
    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=args.k_sigma,
                      stop=args.stop)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, state, log = train(params, model.loss_fn, RULES[args.rule](),
                               sampler, steps=args.steps,
                               inconsistent=not args.consistent,
                               isgd_cfg=icfg, lr_fn=constant_lr(args.lr),
                               log_every=5)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({dt/args.steps*1e3:.0f} ms/step) "
          f"accelerated={state.accel_count} sub_iters={state.sub_iters}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return {"log": log, "state": state, "seconds": dt, "steps": args.steps,
            "peak_bytes": peak, "params": n_params}


def main(argv=None) -> dict:
    args = parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:        # the CLI boundary: no card, no --device cpu
        raise SystemExit(f"error: {e}") from None
    return run(args)


if __name__ == "__main__":
    main()
