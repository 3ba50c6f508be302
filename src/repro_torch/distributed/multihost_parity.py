"""Multi-host parity harness: a pod mesh against a flat data mesh.

Port of ``repro.distributed.multihost_parity``. The acceptance check of the
pod axis: N ranks on a ``(pod=P, data=N/P)`` mesh (P nodes of N/P ranks, as
``torchrun`` would lay them out: ``LOCAL_WORLD_SIZE`` = N/P) must be
bit-exact with N ranks on a ``(data=N)`` mesh (one node) — the same final
params, per-step loss/ψ̄/limit series, ψ queue and accelerate/subproblem
counters — on the per-step engine, the fused engine (K steps a chunk) and
the ``sched`` FCPR path, all driving a ψ̄-dependent ``lr_fn``
(``LEGS``).

Why bit-exactness holds: the data strategy reduces ψ and the gradients
with ``AxisReduce(deterministic=True)`` over the flattened ``(pod, data)``
group in pod-major rank order (``launch.mesh.mesh_group``), so the f32
association is a function of the shard values only; and each rank's
``DeviceRing`` holds its stripe of the globally permuted epoch, which the
harness proves are the single-node ring's rows: the union of the stripes
equals the single-node relaid-out epoch, bit for bit, and the SPC queue
after one epoch is identical ("one ψ window = one epoch").

The fused legs need collectives a CUDA graph can hold: on the CPU they
run (a plain loop); on the card over NCCL; over gloo on the card (ranks
sharing it) they are left out and named in ``omitted``.

Ranks are spawned processes over a file store, each with a timeout
(``launch.env.spawn_ranks``):

    PYTHONPATH=src python -m repro_torch.distributed.multihost_parity \\
        --device cpu --procs 4 [--pods 2] [--steps 32 --chunk-steps 32]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

LEGS = ("perstep", "chunked", "sched")

# the canonical dim-6 linear problem of distributed.hybrid_parity
DIM = 6
N_BATCHES = 4
PER_DEVICE_BATCH = 8


def _child(rank, world, local, steps, K, device):
    """``spawn_ranks`` target: one rank of a node of ``local`` ranks."""
    os.environ["LOCAL_WORLD_SIZE"] = str(local)
    import torch
    import torch.distributed as dist

    from repro_torch.core import ISGDConfig
    from repro_torch.data import DeviceRing, FCPRSampler
    from repro_torch.device import resolve_device
    from repro_torch.distributed.data_parallel import (
        data_axis_size, make_chunked_hybrid_step, make_hybrid_step)
    from repro_torch.launch.mesh import local_data_block, make_training_mesh
    from repro_torch.optim import momentum
    from repro_torch.sched import FCPRSchedule
    from repro_torch.train import host_metrics

    dev = resolve_device(device)
    mesh = make_training_mesh(device=dev.type)   # (N,1) / (pod, N/pod, 1)
    n_data = data_axis_size(mesh)
    batch_size = PER_DEVICE_BATCH * n_data
    assert steps % K == 0 and steps >= 2 * N_BATCHES

    rng = np.random.RandomState(0)
    xs = rng.randn(batch_size * N_BATCHES, DIM).astype(np.float32)
    ys = ((xs @ rng.randn(DIM, 1).astype(np.float32)).ravel()
          / np.sqrt(DIM)).astype(np.float32)
    ys[:batch_size] += 3.0                      # the under-trained batch
    sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=batch_size, seed=1)
    rule = momentum(0.9)
    icfg = ISGDConfig(n_batches=N_BATCHES, k_sigma=1.0, stop=3, zeta=0.01)

    def lr_fn(psi_bar):
        # ψ̄-dependent on purpose: a frozen/diverged ψ̄ shifts the params
        return 0.01 + 0.001 * torch.clamp(psi_bar, max=1.0)

    def make():
        params = [torch.zeros(DIM, device=dev, requires_grad=True),
                  torch.zeros((), device=dev, requires_grad=True)]

        def loss_fn(batch):
            pred = batch["x"] @ params[0] + params[1]
            loss = torch.mean((pred - batch["y"]) ** 2)
            return loss, loss
        return params, loss_fn

    ring = DeviceRing(sampler.epoch_arrays(), batch_size, mesh=mesh,
                      axis=None)
    names = mesh.mesh_dim_names
    out = {"n_dev": np.int64(n_data), "rank": np.int64(rank),
           "mesh": np.asarray([mesh.shape[names.index(a)] if a in names
                               else 1 for a in ("pod", "data", "model")])}
    # FCPR striping evidence: this rank's device-resident rows, tagged
    # with their global row offset
    lo, hi, total = local_data_block(mesh)
    out["block"] = np.asarray([lo, hi, total], np.int64)
    stripe = ring.arrays["x"].cpu().numpy()
    out["stripe_starts"] = np.asarray([lo * stripe.shape[0]], np.int64)
    out["stripe_data"] = stripe
    out["epoch_x"] = sampler.epoch_arrays()["x"]

    def q(state):
        return {"queue_buf": state.queue.buf, "queue_total":
                state.queue.total, "queue_count": state.queue.count}

    def record(leg, state, params, rows, queue_epoch1=None):
        out[f"{leg}_w"] = params[0].detach().cpu().numpy()
        out[f"{leg}_b"] = params[1].detach().cpu().numpy()
        for k in ("loss", "limit", "psi_bar", "accelerated", "sub_iters"):
            out[f"{leg}_{k}"] = np.concatenate([r[k] for r in rows])
        for k, v in q(state).items():
            out[f"{leg}_{k}"] = v.detach().cpu().numpy()
        out[f"{leg}_accel_count"] = np.asarray(int(state.accel_count))
        out[f"{leg}_sub_iters_total"] = np.asarray(int(state.sub_iters))
        if queue_epoch1 is not None:
            out[f"{leg}_queue_epoch1"] = queue_epoch1

    # per-step engine, ψ̄-lagged lr read inside the step
    params, loss_fn = make()
    init_fn, step_fn = make_hybrid_step(loss_fn, rule, icfg, mesh,
                                        lr_fn=lr_fn)
    s, rows, queue_epoch1 = init_fn(params), [], None
    for j in range(steps):
        s, params, m = step_fn(s, params, ring(j))
        rows.append({k: v[None] for k, v in host_metrics(m).items()})
        if j + 1 == N_BATCHES:                 # "one ψ window = one epoch"
            queue_epoch1 = np.concatenate([
                np.asarray(v.detach().cpu().numpy(), np.float32).ravel()
                for v in q(s).values()])
    record("perstep", s, params, rows, queue_epoch1)

    out["fused"] = np.asarray(dev.type != "cuda"
                              or dist.get_backend() == "nccl")
    if not out["fused"]:
        return out

    # fused engine, one chunk call per K steps
    params, loss_fn = make()
    cinit, chunk = make_chunked_hybrid_step(loss_fn, rule, icfg, mesh,
                                            chunk_steps=K, lr_fn=lr_fn)
    s, rows = cinit(params), []
    for c in range(steps // K):
        s, params, ms = chunk(s, params, ring.arrays, c * K)
        rows.append(host_metrics(ms))
    record("chunked", s, params, rows)

    # the scheduler path: the FCPR policy drawn on the device
    fcpr = FCPRSchedule()
    params, loss_fn = make()
    sinit, schunk = make_chunked_hybrid_step(loss_fn, rule, icfg, mesh,
                                             chunk_steps=K, lr_fn=lr_fn,
                                             schedule=fcpr)
    s, rows = sinit(params), []
    ss = fcpr.init(N_BATCHES, device=dev)
    for c in range(steps // K):
        s, params, ss, ms = schunk(s, params, ss, ring.arrays, c * K)
        rows.append(host_metrics(ms))
    record("sched", s, params, rows)
    return out


def _assemble(results, n_rows):
    got = np.full((n_rows, DIM), np.nan, np.float32)
    for w in results:
        start, data = int(w["stripe_starts"][0]), w["stripe_data"]
        got[start:start + data.shape[0]] = data
    return got


def run_multihost_parity(procs: int = 4, pods: int = 2, steps: int = 32,
                         chunk_steps: int = 32, device="cuda", backend=None,
                         timeout: float = 300.0, verbose: bool = False
                         ) -> dict:
    """Spawn ``procs`` ranks on one node (the reference) and ``procs``
    ranks on ``pods`` nodes; compare bit for bit -> {"ok", "legs",
    "striping", ...}."""
    from repro_torch.launch.env import spawn_ranks
    if procs % pods:
        raise ValueError(f"--procs {procs} is not a multiple of --pods {pods}")
    args = (steps, chunk_steps, device)
    R = spawn_ranks(_child, procs, procs, *args, device=device,
                    backend=backend, timeout=timeout)
    W = spawn_ranks(_child, procs, procs // pods, *args, device=device,
                    backend=backend, timeout=timeout)
    keys = ["w", "b", "loss", "limit", "psi_bar", "accelerated",
            "sub_iters", "queue_buf", "queue_total", "queue_count",
            "accel_count", "sub_iters_total"]
    legs = {}
    omitted = [] if bool(R[0]["fused"]) else list(LEGS[1:])
    for leg in (leg for leg in LEGS if leg not in omitted):
        bad = []
        for key in keys + (["queue_epoch1"] if leg == "perstep" else []):
            k = f"{leg}_{key}"
            if not np.array_equal(R[0][k], W[0][k]):
                bad.append(f"{key}: ref!=pods (maxdiff "
                           f"{np.max(np.abs(R[0][k] - W[0][k]))})")
            if not all(np.array_equal(W[0][k], w[k]) for w in W[1:]):
                bad.append(f"{key}: rank replicas differ")
        legs[leg] = {"ok": not bad, "bad": bad,
                     "accelerations": int(R[0][f"{leg}_accel_count"])}

    n_rows = R[0]["epoch_x"].shape[0]
    assembled, ref_assembled = _assemble(W, n_rows), _assemble(R, n_rows)
    bs = n_rows // N_BATCHES
    n_dev = int(R[0]["n_dev"])
    expect = (R[0]["epoch_x"].reshape(N_BATCHES, n_dev, bs // n_dev, DIM)
              .swapaxes(0, 1).reshape(n_rows, DIM))
    striping = {
        "union_covers_epoch": bool(np.isfinite(assembled).all()),
        "union_equals_singlehost": bool(np.array_equal(assembled,
                                                       ref_assembled)),
        "matches_analytic_relayout": bool(np.array_equal(assembled, expect)),
        "epoch_equal_across_processes": all(
            np.array_equal(w["epoch_x"], R[0]["epoch_x"]) for w in W),
    }
    striping["ok"] = all(striping.values())
    ok = all(leg["ok"] for leg in legs.values()) and striping["ok"]
    result = {"ok": ok, "procs": procs, "pods": pods,
              "mesh": W[0]["mesh"].tolist(), "ref_mesh": R[0]["mesh"].tolist(),
              "steps": steps, "K": chunk_steps,
              "accelerations": legs["perstep"]["accelerations"],
              "legs": legs, "omitted": omitted, "striping": striping}
    if verbose or not ok:
        for leg, r in legs.items():
            print(f"  {leg:8s} ok={r['ok']} "
                  f"accel={r['accelerations']} {r['bad'] or ''}")
        print(f"  striping {striping}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=4,
                    help="ranks of each run, one process each")
    ap.add_argument("--pods", type=int, default=2,
                    help="nodes the pod run spreads the ranks over")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default nccl on cuda, gloo on the CPU; ranks "
                         "sharing one card need gloo")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--chunk-steps", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    resolve_device(args.device)
    r = run_multihost_parity(procs=args.procs, pods=args.pods,
                             steps=args.steps, chunk_steps=args.chunk_steps,
                             device=args.device, backend=args.backend,
                             timeout=args.timeout, verbose=args.verbose)
    print(f"multihost-parity procs={r['procs']} mesh(pod,data,model)="
          f"{tuple(r['mesh'])} vs {tuple(r['ref_mesh'])} steps={r['steps']} "
          f"K={r['K']} accelerations={r['accelerations']} "
          f"legs={list(r['legs'])}"
          + (f" omitted={r['omitted']}" if r["omitted"] else "")
          + " -> "
          f"{'OK' if r['ok'] else 'FAIL'}")
    if r["ok"] and not r["accelerations"]:
        print("multihost-parity WARNING: subproblem never fired")
        return 2
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
