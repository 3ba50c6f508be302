"""Scheduler parity matrix: the scheduled engines against the unscheduled
ones, on one device and over the data-parallel group.

Port of ``repro.sched.parity``, driven by a **ψ̄-dependent** ``lr_fn`` (so
any schedule-induced drift in the control statistics breaks the comparison
loudly):

  * **FCPR bit-exactness** — :class:`FCPRSchedule` through the scheduled
    engines reproduces the unscheduled engines exactly: the per-step
    scheduled engine against ``make_train_step`` on host batches, and the
    fused engine at K ∈ {1, 32} against the same per-step reference;
  * **device residency** — the fused ``loss-prop`` engine makes exactly
    ``steps / K`` chunk calls (selection, table update and gather live
    inside the chunk; on the card inside its CUDA graph) and visits every
    batch;
  * **engine agreement** — ``loss-prop`` per-step and fused draw the same
    batches and agree bit for bit (the draw is a pure function of seed,
    step and table);
  * **data-parallel legs** (``repro_torch.distributed``, over the process
    group, or a one-rank group made for the call): ``FCPRSchedule`` through
    the scheduled data-parallel engine, per-step and fused at K = 4, against
    the data-parallel engine on host rows, bit for bit; every rank's
    ``loss-prop`` draws, gathered, agree at every step; the n-rank fused
    ``loss-prop`` run selects the single-device run's batches, its ψ within
    1e-5; and both make ``steps / K`` chunk calls.

    PYTHONPATH=src python -m repro_torch.sched.parity [--device cpu] \
        [--procs N [--backend gloo]]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import ISGDConfig
from repro_torch.data import DeviceRing, FCPRSampler
from repro_torch.device import resolve_device
from repro_torch.optim import momentum
from repro_torch.sched.policies import (FCPRSchedule, LossPropSchedule,
                                        fold_in)
from repro_torch.train import (host_metrics, make_chunked_train_step,
                               make_scheduled_train_step, make_train_step)

KEYS = ("loss", "limit", "psi_bar", "accelerated", "sub_iters")


def run_sched_parity(steps: int = 32, verbose: bool = False,
                     device="cuda", backend=None) -> dict:
    """This rank's matrix -> {"ok": bool, "devices": ranks, "steps",
    "accelerations", "legs": {name: report}}. The data-parallel legs run in
    the existing process group, or in a one-rank group made for the call
    (``backend`` as in ``launch.env.ensure_group``)."""
    from repro_torch.distributed import (batch_sharding,
                                         make_chunked_data_parallel_step,
                                         make_data_parallel_step,
                                         mesh_strategy)
    from repro_torch.launch import env
    from repro_torch.launch.mesh import make_data_mesh
    dev = resolve_device(device)
    n_batches, batch_size, dim = 4, 8, 6
    assert steps % 32 == 0 and steps >= 2 * n_batches
    rng = np.random.RandomState(0)
    xs = rng.randn(batch_size * n_batches, dim).astype(np.float32)
    ys = ((xs @ rng.randn(dim, 1).astype(np.float32)).ravel()
          / np.sqrt(dim)).astype(np.float32)
    ys[:batch_size] += 3.0                      # the under-trained batch
    sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=batch_size, seed=1)
    ring = DeviceRing(sampler.epoch_arrays(), batch_size, device=dev)
    rule = momentum(0.9)
    icfg = ISGDConfig(n_batches=n_batches, k_sigma=1.0, stop=3, zeta=0.01)

    def lr_fn(psi_bar):
        # ψ̄-dependent on purpose: schedule drift moves the LR trajectory
        return 0.01 + 0.001 * torch.clamp(psi_bar, max=1.0)

    def make():
        params = [torch.zeros(dim, device=dev, requires_grad=True),
                  torch.zeros((), device=dev, requires_grad=True)]

        def loss_fn(batch):
            pred = batch["x"] @ params[0] + params[1]
            loss = torch.mean((pred - batch["y"]) ** 2)
            return loss, loss
        return params, loss_fn

    def result(params, state, rows):
        log = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
        return params, int(state.accel_count), log

    def drive(step_fn, init_fn, params, cut=None):
        state, rows = init_fn(params), []
        for j in range(steps):
            host = sampler(j) if cut is None else cut(sampler(j))
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            state, params, m = step_fn(state, params, batch)
            rows.append({k: v[None] for k, v in host_metrics(m).items()})
        return result(params, state, rows)

    def drive_sched(fn, init_fn, params, schedule, K=None, ring=ring):
        state, rows = init_fn(params), []
        ss = schedule.init(n_batches, device=dev)
        calls = 0
        if K is None:
            for j in range(steps):
                state, params, ss, m = fn(state, params, ss, ring.arrays, j)
                rows.append({k: v[None] for k, v in host_metrics(m).items()})
        else:
            for c in range(steps // K):
                state, params, ss, ms = fn(state, params, ss, ring.arrays,
                                           c * K)
                calls += 1
                rows.append(host_metrics(ms))
        return result(params, state, rows) + (calls,)

    def bit_exact(ref, got):
        ok = all(np.array_equal(ref[2][k], got[2][k]) for k in KEYS)
        dev_ = max(float((a.detach() - b.detach()).abs().max())
                   for a, b in zip(ref[0], got[0]))
        return bool(ok and dev_ == 0.0 and ref[1] == got[1]), dev_

    legs = {}
    fcpr = FCPRSchedule()
    params, loss_fn = make()
    init_fn, step = make_train_step(loss_fn, rule, icfg, lr_fn=lr_fn)
    ref = drive(step, init_fn, params)
    assert ref[2]["accelerated"].sum() > 0, "subproblem never fired"

    params, loss_fn = make()
    sinit, sstep = make_scheduled_train_step(loss_fn, rule, icfg, fcpr,
                                             lr_fn=lr_fn)
    ok, dev_ = bit_exact(ref, drive_sched(sstep, sinit, params, fcpr))
    legs["sched-fcpr per-step"] = {"ok": ok, "max_param": dev_}

    for K in (1, 32):
        params, loss_fn = make()
        cinit, chunk = make_chunked_train_step(
            loss_fn, rule, icfg, chunk_steps=K, lr_fn=lr_fn, schedule=fcpr)
        ok, dev_ = bit_exact(ref, drive_sched(chunk, cinit, params, fcpr, K))
        legs[f"sched-fcpr chunked K{K}"] = {"ok": ok, "max_param": dev_}

    lp, K = LossPropSchedule(eps=0.2), 8
    params, loss_fn = make()
    cinit, chunk = make_chunked_train_step(
        loss_fn, rule, icfg, chunk_steps=K, lr_fn=lr_fn, schedule=lp)
    fused = drive_sched(chunk, cinit, params, lp, K)
    params, loss_fn = make()
    sinit, sstep = make_scheduled_train_step(loss_fn, rule, icfg, lp,
                                             lr_fn=lr_fn)
    per_step = drive_sched(sstep, sinit, params, lp)
    ok, dev_ = bit_exact(per_step, fused)
    ok &= np.array_equal(per_step[2]["batch_idx"], fused[2]["batch_idx"])
    legs["loss-prop per-step = fused"] = {"ok": bool(ok), "max_param": dev_}
    # device residency: one chunk call per K steps, no per-step host work
    legs["loss-prop dispatches = steps/K"] = {
        "ok": fused[3] == steps // K, "max_param": None}
    legs["loss-prop visits all batches"] = {
        "ok": bool((np.bincount(fused[2]["batch_idx"].astype(np.int64),
                                minlength=n_batches) > 0).all()),
        "max_param": None}

    with env.local_group(dev, backend):
        mesh = make_data_mesh(dev.type, backend)
        n_dev = mesh.size()
        ring_m = DeviceRing(sampler.epoch_arrays(), batch_size, mesh=mesh)
        params, loss_fn = make()
        dinit, dstep = make_data_parallel_step(loss_fn, rule, icfg, mesh,
                                               lr_fn=lr_fn)
        dp = drive(dstep, dinit, params, cut=batch_sharding(mesh))
        params, loss_fn = make()
        sinit, sstep = make_data_parallel_step(loss_fn, rule, icfg, mesh,
                                               lr_fn=lr_fn, schedule=fcpr)
        ok, dev_ = bit_exact(dp, drive_sched(sstep, sinit, params, fcpr,
                                             ring=ring_m))
        legs["sched-fcpr dp per-step"] = {"ok": ok, "max_param": dev_}
        params, loss_fn = make()
        cinit, chunk = make_chunked_data_parallel_step(
            loss_fn, rule, icfg, mesh, chunk_steps=4, lr_fn=lr_fn,
            schedule=fcpr)
        ok, dev_ = bit_exact(dp, drive_sched(chunk, cinit, params, fcpr, 4,
                                             ring=ring_m))
        legs["sched-fcpr dp chunked K4"] = {"ok": ok, "max_param": dev_}

        # loss-prop: every rank draws from the same table and step; the
        # draws, gathered, must agree at every step
        table = torch.from_numpy(
            rng.rand(n_batches).astype(np.float32) * 3.0).to(dev)
        visits = torch.ones((n_batches,), dtype=torch.int32, device=dev)
        js = range(n_batches, n_batches + 16)         # post-warm-up draws
        mine = torch.stack([lp.select({"table": table, "visits": visits},
                                      j, fold_in(0, j, device=dev))[0]
                            for j in js]).to(torch.float32)
        draws = mesh_strategy(mesh).reduce_ctx.gather(
            mine, torch.empty(n_dev, mine.numel(), device=dev))
        legs["loss-prop shard-draw agreement"] = {
            "ok": bool((draws == draws[0]).all()), "max_param": None}

        # loss-prop: the n-rank fused run selects the 1-device run's batches
        params, loss_fn = make()
        cinit, chunk = make_chunked_data_parallel_step(
            loss_fn, rule, icfg, mesh, chunk_steps=K, lr_fn=lr_fn,
            schedule=lp)
        many = drive_sched(chunk, cinit, params, lp, K, ring=ring_m)
    finite = np.isfinite(fused[2]["loss"])
    legs["loss-prop 1-vs-n-device selection"] = {
        "ok": bool(np.array_equal(fused[2]["batch_idx"],
                                  many[2]["batch_idx"])
                   and np.allclose(fused[2]["loss"][finite],
                                   many[2]["loss"][finite], atol=1e-5,
                                   rtol=1e-5)),
        "max_param": None}
    # device residency: one chunk call per K steps, no per-step host work
    legs["loss-prop dispatches = steps/K"] = {
        "ok": fused[3] == steps // K and many[3] == steps // K,
        "max_param": None}

    if verbose:
        _print_legs(legs)
    return {"ok": all(leg["ok"] for leg in legs.values()),
            "devices": n_dev, "steps": steps,
            "accelerations": int(ref[2]["accelerated"].sum()), "legs": legs}


def _print_legs(legs: dict) -> None:
    for name, leg in legs.items():
        print(f"  {name:34s} ok={leg['ok']} max_param={leg['max_param']}")


def _rank(rank, world, steps, device):
    """``spawn_ranks`` target: one rank's ``run_sched_parity``."""
    return run_sched_parity(steps=steps, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=1,
                    help="data-parallel ranks to spawn (1: this process)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.procs == 1:
        r = run_sched_parity(steps=args.steps, verbose=args.verbose,
                             device=args.device, backend=args.backend)
    else:
        from repro_torch.launch.env import spawn_ranks
        ranks = spawn_ranks(_rank, args.procs, args.steps, args.device,
                            device=args.device, backend=args.backend)
        r = dict(ranks[0], ok=all(x["ok"] for x in ranks))
        if args.verbose:
            _print_legs(r["legs"])
    bad = [n for n, leg in r["legs"].items() if not leg["ok"]]
    print(f"sched-parity devices={r['devices']} steps={r['steps']} "
          f"accelerations={r['accelerations']} legs={len(r['legs'])} "
          f"failed={bad or 'none'} -> {'OK' if r['ok'] else 'FAIL'}")
    if r["accelerations"] == 0:
        print("sched-parity WARNING: subproblem never fired")
        return 2
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
