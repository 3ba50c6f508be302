"""Async-PS parity / convergence check (runnable, mirrors
``repro_torch.distributed.parity``).

Port of ``repro.distributed.async_ps.parity``. Two modes over the same
rigged problem (least squares with one outlier batch per FCPR cycle so the
conservative subproblem fires, driven by a ψ̄-dependent LR so the one-step
queue lag is exercised):

  * ``--workers 1`` (default, ``max_staleness`` 0): the acceptance anchor —
    the async engine must be **bit-exact** with the port's per-step engine:
    losses, control limits, accelerate decisions, sub-iteration counts,
    ψ̄/σ, final params and final counters, over ``--steps`` covering ≥ 4
    FCPR epochs.
  * ``--workers N`` (N > 1): convergence — the async run's final-epoch mean
    ψ̄ within ``--tol`` of the per-step engine's on the same global cycle,
    with the recorded version staleness τ within the gate's bound.

The run is on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.distributed.async_ps.parity [--device cpu]
  PYTHONPATH=src python -m repro_torch.distributed.async_ps.parity \\
      --workers 2 --max-staleness 2 --steps 64 --tol 0.25
"""
from __future__ import annotations

import argparse


def _problem(batch_size: int, n_batches: int, dim: int = 6, seed: int = 0,
             device="cuda"):
    """The reference's rig, the same numpy draws. -> ``(make, sampler,
    icfg)``; ``make()`` -> fresh ``(params, loss_fn)``, params ``[w, b]``
    (the reference's ``{"w", "b"}``) at zero."""
    import numpy as np
    import torch

    from repro_torch.core import ISGDConfig
    from repro_torch.data import FCPRSampler

    rng = np.random.RandomState(seed)
    xs = rng.randn(batch_size * n_batches, dim).astype(np.float32)
    ys = ((xs @ rng.randn(dim, 1).astype(np.float32)).ravel()
          / np.sqrt(dim)).astype(np.float32)
    ys[:batch_size] += 3.0                    # the under-trained batch

    def make():
        params = [torch.zeros(dim, device=device, requires_grad=True),
                  torch.zeros((), device=device, requires_grad=True)]

        def loss_fn(batch):
            pred = batch["x"] @ params[0] + params[1]
            loss = torch.mean((pred - batch["y"]) ** 2)
            return loss, loss
        return params, loss_fn

    sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=batch_size, seed=1)
    # zeta=None on purpose: the subproblem's ζ then tracks the ψ̄-driven LR
    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=1.0, stop=3)
    return make, sampler, icfg


def _lr_fn(psi_bar):
    import torch
    # ψ̄-dependent: any queue-lag regression shifts the whole trajectory
    return 0.01 + 0.001 * torch.clamp(psi_bar, max=1.0)


METRIC_KEYS = ("loss", "psi_bar", "psi_std", "limit", "accelerated",
               "sub_iters")


def run_async_parity(steps: int = 32, *, workers: int = 1,
                     max_staleness: int = 0, tol: float = 0.25,
                     batch_size: int = 8, n_batches: int = 4,
                     decay: str = "inverse", verbose: bool = False,
                     device="cuda") -> dict:
    """Returns {"ok": bool, "mode": "bitexact"|"convergence", ...}."""
    import torch

    from repro_torch.core.reduce import StalenessReduce
    from repro_torch.device import resolve_device
    from repro_torch.distributed.async_ps.coordinator import (
        AsyncPSCoordinator, ShardedFeed)
    from repro_torch.optim import momentum
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import host_metrics

    dev = resolve_device(device)
    if n_batches % workers:
        n_batches = 4 * workers       # every worker owns a whole FCPR shard
    make, sampler, icfg = _problem(batch_size, n_batches, device=dev)
    rule = momentum(0.9)
    bitexact = workers == 1 and max_staleness == 0

    # synchronous per-step reference over the same global FCPR cycle
    ref_p, loss_fn = make()
    init_fn, step = make_train_step(loss_fn, rule, icfg, lr_fn=_lr_fn)
    ref_s = init_fn(ref_p)
    feed = ShardedFeed(sampler, 0, 1, dev)
    ref = []
    for j in range(steps):
        ref_s, ref_p, m = step(ref_s, ref_p, feed(j))
        ref.append({k: float(v) for k, v in host_metrics(
            {k: m[k] for k in METRIC_KEYS}).items()})

    params0, _ = make()
    coord = AsyncPSCoordinator(
        lambda w: make(), rule, icfg, workers=workers,
        max_staleness=max_staleness, lr_fn=_lr_fn,
        reduce_ctx=StalenessReduce(decay=decay))
    got_p, got_s, recs = coord.run(params0, sampler, steps)

    n_accel = sum(r["accelerated"] for r in recs)
    taus = [r["tau"] for r in recs]
    out = {"workers": workers, "max_staleness": max_staleness, "steps": steps,
           "accelerations": n_accel, "max_tau": max(taus),
           "tau_bound": (2 * max_staleness + 1) * (workers - 1)}

    if bitexact:
        mism = 0
        for j, (r, g) in enumerate(zip(ref, recs)):
            for key in METRIC_KEYS:
                if float(r[key]) != float(g[key]):
                    mism += 1
                    if verbose:
                        print(f"step {j} {key}: sync={float(r[key])!r} "
                              f"async={float(g[key])!r}")
        dparam = max(float(torch.max(torch.abs(a.detach() - b)))
                     for a, b in zip(ref_p, got_p))
        counters_ok = (ref_s.accel_count == got_s.accel_count
                       and ref_s.sub_iters == got_s.sub_iters
                       and ref_s.iter == got_s.iter)
        out.update(mode="bitexact", metric_mismatches=mism,
                   max_param_dev=dparam, counters_ok=counters_ok,
                   ok=(mism == 0 and dparam == 0.0 and counters_ok
                       and max(taus) == 0 and n_accel > 0))
    else:
        n_b = sampler.n_batches
        sync_final = sum(r["psi_bar"] for r in ref[-n_b:]) / n_b
        async_final = sum(r["psi_bar"] for r in recs[-n_b:]) / n_b
        out.update(mode="convergence", sync_final_psi_bar=sync_final,
                   async_final_psi_bar=async_final,
                   ok=(abs(sync_final - async_final) <= tol
                       and max(taus) <= out["tau_bound"] and n_accel > 0))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--max-staleness", type=int, default=0)
    ap.add_argument("--n-batches", type=int, default=4,
                    help="global FCPR batches per epoch (auto-bumped to "
                         "4*workers when not divisible by --workers)")
    ap.add_argument("--tol", type=float, default=0.25,
                    help="final-epoch mean ψ̄ tolerance (multi-worker mode)")
    ap.add_argument("--decay", default="inverse")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when named")
    args = ap.parse_args(argv)
    r = run_async_parity(args.steps, workers=args.workers,
                         max_staleness=args.max_staleness, tol=args.tol,
                         n_batches=args.n_batches, decay=args.decay,
                         verbose=args.verbose, device=args.device)
    items = " ".join(f"{k}={v}" for k, v in r.items() if k != "ok")
    print(f"async-ps parity device={args.device} {items} -> "
          f"{'OK' if r['ok'] else 'FAIL'}")
    if r["accelerations"] == 0:
        print("parity WARNING: subproblem never fired; cond path untested")
        return 2
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
