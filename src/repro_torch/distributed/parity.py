"""Distributed-parity check: the N-rank data-parallel engine against the
single-device engine.

Port of ``repro.distributed.parity``. Each rank runs the same FCPR batch
sequence through (a) the single-device engine (``make_train_step``) on the
full global batch and (b) the data-parallel engine
(``make_data_parallel_step``) on its rows, fed by ``prefetched(sampler,
mesh)``, and compares params, ψ̄, the control limit and the accelerate
decision step by step. The problem is the reference's rigged least squares
(one outlier batch a cycle breaks ψ̄ + kσ after warm-up), so the comparison
covers the accelerate branch and the Alg. 2 trips, not only the base
update. At the end the ranks gather their params and check the replicas
are bit-identical.

Usable two ways:

  * in-process, ``run_parity(...)``: this rank's part, in the existing
    process group, or in a one-rank group made for the call;
  * as a module that spawns the ranks (``launch.env.spawn_ranks``, a file
    store, no network):

      PYTHONPATH=src python -m repro_torch.distributed.parity --procs 2 \\
          --device cpu
      python -m repro_torch.distributed.parity --procs 2 --device cuda \\
          --backend gloo          # two ranks sharing one card
      python -m repro_torch.distributed.parity --procs 1 --device cuda \\
          --backend nccl

Exit status 0 iff every deviation is within ``--tol`` (default 1e-5, the
reference's), 1 otherwise, 2 if the subproblem never fired.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import ISGDConfig, constant_lr
from repro_torch.data import FCPRSampler
from repro_torch.device import resolve_device
from repro_torch.optim import momentum

LR = 0.01


def problem(device, batch_size: int = 32, n_batches: int = 4, dim: int = 8):
    """The reference's rig: ``(make, sampler, icfg)``, ``make()`` -> fresh
    ``(params, loss_fn)`` (params ``[w (dim,), b ()]``, a MEAN loss, so
    per-shard means average to the global mean)."""
    rng = np.random.RandomState(0)
    xs = rng.randn(batch_size * n_batches, dim).astype(np.float32)
    ys = ((xs @ rng.randn(dim, 1).astype(np.float32)).ravel()
          / np.sqrt(dim)).astype(np.float32)
    ys[:batch_size] += 3.0                        # the under-trained batch
    sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=batch_size, seed=1)

    def make():
        params = [torch.zeros(dim, device=device, requires_grad=True),
                  torch.zeros((), device=device, requires_grad=True)]

        def loss_fn(batch):
            pred = batch["x"] @ params[0] + params[1]
            loss = torch.mean((pred - batch["y"]) ** 2)
            return loss, loss
        return params, loss_fn

    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=1.0, stop=3,
                      zeta=0.01)
    return make, sampler, icfg


def _flat(params) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in params])


def run_parity(steps: int = 20, tol: float = 1e-5, *, batch_size: int = 32,
               n_batches: int = 4, verbose: bool = False, device="cuda",
               backend=None, trace: bool = False) -> dict:
    """This rank's check (module doc) -> {"ok", "devices", "steps",
    "accelerations", "accel_mismatch", "max_param", "max_psi_bar",
    "max_limit", "replicas_identical"}; with ``trace``, also "trace":
    the data-parallel engine's per-step ``params`` (steps, dim + 1),
    ``loss``, ``psi_bar``, ``limit`` and ``accelerated``, as numpy."""
    from repro_torch.distributed.data_parallel import (
        make_data_parallel_step, mesh_strategy)
    from repro_torch.distributed.prefetch import prefetched
    from repro_torch.launch import env
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.train.trainer import make_train_step

    dev = resolve_device(device)
    make, sampler, icfg = problem(dev, batch_size, n_batches)
    rule, lr_fn = momentum(0.9), constant_lr(LR)
    with env.local_group(dev, backend):
        mesh = make_data_mesh(dev.type, backend)
        n_dev = mesh.size()
        if batch_size % n_dev:
            raise ValueError(f"batch {batch_size} is not divisible by "
                             f"{n_dev} ranks")
        ref_params, ref_loss = make()
        ref_init, ref_step = make_train_step(ref_loss, rule, icfg,
                                             lr_fn=lr_fn)
        ref_state = ref_init(ref_params)
        dp_params, dp_loss = make()
        dp_init, dp_step = make_data_parallel_step(dp_loss, rule, icfg, mesh,
                                                   lr_fn=lr_fn)
        dp_state = dp_init(dp_params)
        feed = prefetched(sampler, mesh, device=dev)

        dev_ = {"param": 0.0, "psi_bar": 0.0, "limit": 0.0}
        accel_mismatch = n_accel = 0
        rows = {k: [] for k in ("params", "loss", "psi_bar", "limit",
                                "accelerated")}
        for j in range(steps):
            host = {k: torch.from_numpy(v).to(dev)
                    for k, v in sampler(j).items()}
            ref_state, ref_params, mr = ref_step(ref_state, ref_params, host)
            dp_state, dp_params, md = dp_step(dp_state, dp_params, feed(j))
            dev_["param"] = max(dev_["param"], float(
                (_flat(ref_params) - _flat(dp_params)).abs().max()))
            dev_["psi_bar"] = max(dev_["psi_bar"], abs(
                float(mr["psi_bar"]) - float(md["psi_bar"])))
            lim_r, lim_d = float(mr["limit"]), float(md["limit"])
            if not (lim_r == lim_d == float("inf")):
                dev_["limit"] = max(dev_["limit"], abs(lim_r - lim_d))
            accel_mismatch += int(bool(mr["accelerated"])
                                  != bool(md["accelerated"]))
            n_accel += int(bool(mr["accelerated"]))
            if trace:
                rows["params"].append(_flat(dp_params).cpu().numpy())
                for k in ("loss", "psi_bar", "limit"):
                    rows[k].append(float(md[k]))
                rows["accelerated"].append(bool(md["accelerated"]))
            if verbose:
                print(f"step {j:3d} loss={float(mr['loss']):8.4f} "
                      f"accel={bool(mr['accelerated'])} "
                      f"dparam={dev_['param']:.2e}")
        # the replicas: every rank's params gathered, all rows equal
        strat = mesh_strategy(mesh)
        flat = _flat(dp_params).to(torch.float32)
        gathered = strat.reduce_ctx.gather(
            flat, torch.empty(n_dev, flat.numel(), device=dev))
        same = bool((gathered == gathered[0]).all())
    ok = (accel_mismatch == 0 and same
          and all(v <= tol for v in dev_.values()))
    out = {"ok": ok, "devices": n_dev, "steps": steps,
           "accelerations": n_accel, "accel_mismatch": accel_mismatch,
           "max_param": dev_["param"], "max_psi_bar": dev_["psi_bar"],
           "max_limit": dev_["limit"], "replicas_identical": same}
    if trace:
        out["trace"] = {k: np.asarray(v) for k, v in rows.items()}
    return out


def _rank(rank, world, steps, tol, device, trace):
    """``spawn_ranks`` target: one rank's ``run_parity``."""
    return run_parity(steps=steps, tol=tol, device=device, trace=trace)


def run_parity_ranks(procs: int, steps: int = 20, tol: float = 1e-5, *,
                     device="cuda", backend=None, trace: bool = False,
                     timeout: float = 300.0) -> list:
    """``run_parity`` on ``procs`` spawned ranks -> their results, in rank
    order."""
    from repro_torch.launch.env import spawn_ranks
    return spawn_ranks(_rank, procs, steps, tol, device, trace,
                       device=device, backend=backend, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=1,
                    help="ranks to spawn (1: this process, a one-rank group)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default nccl on cuda, gloo on the CPU")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.procs == 1:
        results = [run_parity(steps=args.steps, tol=args.tol,
                              verbose=args.verbose, device=args.device,
                              backend=args.backend)]
    else:
        results = run_parity_ranks(args.procs, args.steps, args.tol,
                                   device=args.device, backend=args.backend)
    r = results[0]
    ok = all(x["ok"] for x in results)
    backend = args.backend or ("nccl" if args.device.startswith("cuda")
                               else "gloo")
    print(f"parity devices={r['devices']} device={args.device} "
          f"backend={backend} steps={r['steps']} "
          f"accelerations={r['accelerations']} "
          f"accel_mismatch={r['accel_mismatch']} "
          f"max_param={r['max_param']:.3e} "
          f"max_psi_bar={r['max_psi_bar']:.3e} "
          f"max_limit={r['max_limit']:.3e} "
          f"replicas_identical={r['replicas_identical']} -> "
          f"{'OK' if ok else 'FAIL'}")
    if r["accelerations"] == 0:
        print("parity WARNING: subproblem never fired; cond path untested")
        return 2
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
