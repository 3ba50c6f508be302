"""Hybrid DP × TP parity matrix: the unified engine against its references.

Port of ``repro.distributed.hybrid_parity``. Every leg drives a
**ψ̄-dependent** ``lr_fn``: an engine that dropped the running loss average
from the schedule (Alg. 1 line 19) would leave the reference's trajectory
within an epoch, and a control leg frozen at ``lr_fn(0.0)`` must differ,
proving the matrix can catch it. Legs (``n`` = ranks; ≥ 2 FCPR epochs with
the subproblem firing):

  * ``hybrid(1,1)``   vs the per-step ``make_train_step``   — bit-exact
    (a one-rank group of its own);
  * ``hybrid(n,1)``   vs the data-parallel engine (1-D mesh) — bit-exact;
  * ``hybrid(1,n)``   vs the per-step reference              — bit-exact
    (the tensor-parallel strategy; the toy params are below the rules'
    128 floor, so they stay replicated and every rank runs the reference
    program on the global batch);
  * ``chunked(n,1)K`` fused vs ``hybrid(n,1)``, ``chunked(1,n)K`` fused vs
    the reference (its ring in global row order)             — bit-exact;
  * ``sched-fcpr(n,1)K``/``sched-fcpr(1,n)K``: the same fused legs with
    the batch drawn by the ``sched`` FCPR policy              — bit-exact;
  * ``sharded-tp(model=2)``: a (128, 8) weight split over ``model=2``
    (``(None, "model")``) vs the reference, within ``tol``, with equal
    accelerations above 0;
  * ``data-parallel`` vs the reference                        — within tol.

The fused legs need a backend whose collectives a CUDA graph can hold: on
the CPU they run (the fused engine is a plain loop there); on the card
they run over NCCL, so over gloo on the card (two ranks sharing it) they
are left out of the matrix and named in ``omitted``; run ``--procs 1`` for
them there.

Ranks are spawned processes, one each, over a file store
(``launch.env.spawn_ranks``), each with a timeout:

    PYTHONPATH=src python -m repro_torch.distributed.hybrid_parity \\
        --device cpu --procs 2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

KEYS = ("loss", "limit", "psi_bar", "accelerated", "sub_iters")


def _problem(n: int, dev, rng):
    from repro_torch.data import FCPRSampler
    n_batches, dim = 4, 6
    batch_size = 8 * n
    xs = rng.randn(batch_size * n_batches, dim).astype(np.float32)
    ys = ((xs @ rng.randn(dim, 1).astype(np.float32)).ravel()
          / np.sqrt(dim)).astype(np.float32)
    ys[:batch_size] += 3.0                      # the under-trained batch
    sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=batch_size, seed=1)

    def make():
        params = [torch.zeros(dim, device=dev, requires_grad=True),
                  torch.zeros((), device=dev, requires_grad=True)]

        def loss_fn(batch):
            pred = batch["x"] @ params[0] + params[1]
            loss = torch.mean((pred - batch["y"]) ** 2)
            return loss, loss
        return params, loss_fn
    return sampler, make, n_batches, batch_size


def _lr_fn(psi_bar):
    # ψ̄-dependent on purpose: freezing ψ̄=0 shifts the whole trajectory
    return 0.01 + 0.001 * torch.clamp(psi_bar, max=1.0)


def run_hybrid_parity(steps: int = 32, K: int = 4, tol: float = 1e-5,
                      device="cuda", only11: bool = False) -> dict:
    """This rank's matrix over the process group (module doc) ->
    {"ok", "devices", "steps", "K", "accelerations", "legs", "omitted"}.
    ``only11``: just the ``hybrid(1,1)`` leg (a one-rank group)."""
    import torch.distributed as dist

    from repro_torch.core import ISGDConfig
    from repro_torch.data import DeviceRing
    from repro_torch.device import resolve_device
    from repro_torch.distributed.data_parallel import (
        BatchShard, make_chunked_hybrid_step, make_data_parallel_step,
        make_hybrid_step, mesh_strategy)
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh
    from repro_torch.launch.shardings import hybrid_params_placement
    from repro_torch.optim import momentum
    from repro_torch.sched import FCPRSchedule
    from repro_torch.train import host_metrics, make_train_step

    dev = resolve_device(device)
    n = dist.get_world_size()
    assert steps % K == 0 and steps >= 8, (steps, K)
    rng = np.random.RandomState(0)
    sampler, make, n_batches, batch_size = _problem(n, dev, rng)
    rule = momentum(0.9)
    icfg = ISGDConfig(n_batches=n_batches, k_sigma=1.0, stop=3, zeta=0.01)

    def result(params, state, rows):
        log = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
        return ([p.detach().cpu().numpy().copy() for p in params],
                int(state.accel_count), log)

    def feed_for(mesh):
        """Rows of the data rank (data strategy), the global batch
        (tensor-parallel strategy)."""
        if mesh is None or mesh_strategy(mesh).tensor_parallel:
            return lambda b: b
        g = mesh_strategy(mesh).group
        return BatchShard(g.rank(), g.size())

    def place(mesh, params):
        if mesh is None or not mesh_strategy(mesh).tensor_parallel:
            return params
        return hybrid_params_placement(mesh, params)[0]

    def drive(step_fn, init_fn, params, mesh=None, smp=sampler):
        cut = feed_for(mesh)
        params = place(mesh, params)
        state, rows = init_fn(params), []
        for j in range(steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in cut(smp(j)).items()}
            state, params, m = step_fn(state, params, batch)
            rows.append({k: v[None] for k, v in host_metrics(m).items()})
        return result(params, state, rows)

    def drive_chunked(chunk_fn, init_fn, params, ring, mesh, sched=None):
        params = place(mesh, params)
        state, rows = init_fn(params), []
        ss = None if sched is None else sched.init(n_batches, device=dev)
        for c in range(steps // K):
            if sched is None:
                state, params, ms = chunk_fn(state, params, ring.arrays,
                                             c * K)
            else:
                state, params, ss, ms = chunk_fn(state, params, ss,
                                                 ring.arrays, c * K)
            rows.append(host_metrics(ms))
        return result(params, state, rows)

    def compare(ref, got, exact):
        """(ok, max_param_dev) of two (params, accel, log) results."""
        dev_ = max(float(np.max(np.abs(a - b)))
                   for a, b in zip(ref[0], got[0]))
        ok = True
        for key in KEYS:
            a, b = ref[2][key], got[2][key]
            if exact:
                ok &= bool(np.array_equal(a, b))
                continue
            a, b = a.astype(np.float64), b.astype(np.float64)
            fin = np.isfinite(a) & np.isfinite(b)
            ok &= bool(np.array_equal(a[~fin], b[~fin]))
            ok &= bool(np.allclose(a[fin], b[fin], atol=tol, rtol=tol))
        ok &= (dev_ == 0.0 and ref[1] == got[1]) if exact else dev_ <= tol
        return bool(ok), dev_

    legs, omitted = {}, []
    params, loss_fn = make()
    init_fn, step = make_train_step(loss_fn, rule, icfg, lr_fn=_lr_fn)
    ref = drive(step, init_fn, params)
    accel = int(ref[2]["accelerated"].sum())

    if only11:
        mesh11 = make_host_mesh(model=1, device=dev.type)
        params, loss_fn = make()
        hinit, hstep = make_hybrid_step(loss_fn, rule, icfg, mesh11,
                                        lr_fn=_lr_fn)
        ok, d = compare(ref, drive(hstep, hinit, params, mesh11), True)
        legs["hybrid(1,1)"] = {"ok": ok, "max_param": d}
        return {"ok": ok, "devices": 1, "steps": steps, "K": K,
                "accelerations": accel, "legs": legs, "omitted": []}

    # control: the LR frozen at lr_fn(0.0) must give a DIFFERENT trajectory
    params, loss_fn = make()
    finit, fstep = make_train_step(loss_fn, rule, icfg,
                                   lr_fn=lambda p: _lr_fn(torch.zeros_like(p)))
    frozen = drive(fstep, finit, params)
    legs["frozen-lr-differs"] = {
        "ok": any(not np.array_equal(a, b)
                  for a, b in zip(ref[0], frozen[0])), "max_param": None}

    mesh_d = make_data_mesh(dev.type)
    params, loss_fn = make()
    dinit, dstep = make_data_parallel_step(loss_fn, rule, icfg, mesh_d,
                                           lr_fn=_lr_fn)
    dp = drive(dstep, dinit, params, mesh_d)
    ok, d = compare(ref, dp, exact=n == 1)
    legs["data-parallel"] = {"ok": ok, "max_param": d}

    mesh_n1 = make_host_mesh(model=1, device=dev.type)
    params, loss_fn = make()
    hinit, hstep = make_hybrid_step(loss_fn, rule, icfg, mesh_n1,
                                    lr_fn=_lr_fn)
    hy_n1 = drive(hstep, hinit, params, mesh_n1)
    ok, d = compare(dp, hy_n1, exact=True)
    legs["hybrid(n,1)=dp"] = {"ok": ok, "max_param": d}

    mesh_1n = make_host_mesh(model=n, device=dev.type)
    params, loss_fn = make()
    hinit, hstep = make_hybrid_step(loss_fn, rule, icfg, mesh_1n,
                                    lr_fn=_lr_fn)
    ok, d = compare(ref, drive(hstep, hinit, params, mesh_1n), exact=True)
    legs["hybrid(1,n)"] = {"ok": ok, "max_param": d}

    fused = dev.type != "cuda" or dist.get_backend() == "nccl"
    if fused:
        fcpr = FCPRSchedule()
        ring = DeviceRing(sampler.epoch_arrays(), batch_size, mesh=mesh_n1)
        ring_g = DeviceRing(sampler.epoch_arrays(), batch_size, mesh=mesh_1n,
                            relayout=False)
        for name, mesh, rg, want in (
                (f"chunked(n,1)K{K}", mesh_n1, ring, hy_n1),
                (f"chunked(1,n)K{K}", mesh_1n, ring_g, ref),
                (f"sched-fcpr(n,1)K{K}", mesh_n1, ring, hy_n1),
                (f"sched-fcpr(1,n)K{K}", mesh_1n, ring_g, ref)):
            sched = fcpr if name.startswith("sched") else None
            params, loss_fn = make()
            cinit, chunk = make_chunked_hybrid_step(
                loss_fn, rule, icfg, mesh, chunk_steps=K, lr_fn=_lr_fn,
                schedule=sched)
            got = drive_chunked(chunk, cinit, params, rg, mesh, sched)
            ok, d = compare(want, got, exact=True)
            legs[name] = {"ok": ok, "max_param": d}
    else:
        omitted += [f"chunked(n,1)K{K}", f"chunked(1,n)K{K}",
                    f"sched-fcpr(n,1)K{K}", f"sched-fcpr(1,n)K{K}"]

    if n % 2 == 0:
        # a weight genuinely split over model=2 (within tol: the loss runs
        # on the gathered weight, the gradient slice is the rank's)
        wdim, out = 128, 8
        xs2 = rng.randn(batch_size * n_batches, wdim).astype(np.float32)
        W = rng.randn(wdim, out).astype(np.float32)
        ys2 = (xs2 @ W / np.sqrt(wdim)).astype(np.float32)
        ys2[:batch_size] += 3.0
        from repro_torch.data import FCPRSampler
        smp2 = FCPRSampler({"x": xs2, "y": ys2}, batch_size=batch_size,
                           seed=1)

        def make2():
            params = [torch.zeros((wdim, out), device=dev,
                                  requires_grad=True)]

            def loss2(batch):
                loss = torch.mean((batch["x"] @ params[0] - batch["y"]) ** 2)
                return loss, loss
            return params, loss2

        params, loss2 = make2()
        rinit, rstep = make_train_step(loss2, rule, icfg, lr_fn=_lr_fn)
        r2 = drive(rstep, rinit, params, smp=smp2)
        mesh_tp = make_host_mesh(model=2, device=dev.type)
        params, loss2 = make2()
        local, pl = hybrid_params_placement(mesh_tp, params, names=["w"],
                                            fsdp=False)
        assert pl.specs["w"] == (None, "model"), pl.specs
        h_init, h_step = make_hybrid_step(loss2, rule, icfg, mesh_tp,
                                          lr_fn=_lr_fn)
        cut = feed_for(mesh_tp)
        state = h_init(local)
        rows = []
        for j in range(steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in cut(smp2(j)).items()}
            state, local, m = h_step(state, local, batch)
            rows.append({k: v[None] for k, v in host_metrics(m).items()})
        h2 = result(pl.full(), state, rows)
        d = float(np.max(np.abs(r2[0][0] - h2[0][0])))
        legs["sharded-tp(model=2)"] = {
            "ok": d <= tol and r2[1] == h2[1] and r2[1] > 0,
            "max_param": d, "accelerations": r2[1]}

    ok = all(leg["ok"] for leg in legs.values())
    return {"ok": ok, "devices": n, "steps": steps, "K": K,
            "accelerations": accel, "legs": legs, "omitted": omitted}


def _rank(rank, world, steps, K, tol, device, only11):
    """``spawn_ranks`` target: one rank's matrix."""
    return run_hybrid_parity(steps=steps, K=K, tol=tol, device=device,
                             only11=only11)


def run_hybrid_parity_ranks(procs: int, steps: int = 32, K: int = 4,
                            tol: float = 1e-5, *, device="cuda",
                            backend=None, timeout: float = 300.0) -> dict:
    """The matrix over ``procs`` spawned ranks, plus ``hybrid(1,1)`` on a
    one-rank group of its own. Every rank must agree on every verdict (the
    replicated values are the same bits); -> rank 0's result, with
    ``ranks_agree``."""
    from repro_torch.launch.env import spawn_ranks
    one = spawn_ranks(_rank, 1, steps, K, tol, device, True, device=device,
                      backend=backend, timeout=timeout)[0]
    res = spawn_ranks(_rank, procs, steps, K, tol, device, False,
                      device=device, backend=backend, timeout=timeout)
    agree = all({k: v["ok"] for k, v in x["legs"].items()}
                == {k: v["ok"] for k, v in res[0]["legs"].items()}
                for x in res)
    r = res[0]
    r["legs"] = dict(one["legs"], **r["legs"])
    r["ranks_agree"] = agree
    r["ok"] = r["ok"] and one["ok"] and agree
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2,
                    help="gloo (or --backend) ranks to spawn, one process "
                         "each (the reference's --devices)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default nccl on cuda, gloo on the CPU; two ranks "
                         "sharing one card need gloo")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--chunk-steps", type=int, default=4)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    resolve_device(args.device)
    r = run_hybrid_parity_ranks(args.procs, args.steps, args.chunk_steps,
                                args.tol, device=args.device,
                                backend=args.backend, timeout=args.timeout)
    if args.verbose:
        for name, leg in r["legs"].items():
            print(f"  {name:22s} ok={leg['ok']} max_param={leg['max_param']}")
    bad = [n for n, leg in r["legs"].items() if not leg["ok"]]
    omitted = f" omitted={r['omitted']}" if r["omitted"] else ""
    print(f"hybrid-parity devices={r['devices']} steps={r['steps']} "
          f"K={r['K']} accelerations={r['accelerations']} "
          f"legs={len(r['legs'])} failed={bad or 'none'}{omitted} "
          f"ranks_agree={r['ranks_agree']} -> "
          f"{'OK' if r['ok'] else 'FAIL'}")
    if r["accelerations"] == 0:
        print("hybrid-parity WARNING: subproblem never fired")
        return 2
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
