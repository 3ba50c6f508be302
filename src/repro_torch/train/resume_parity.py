"""Kill-and-resume parity: a checkpointed run resumes **bit for bit**.

Port of ``repro.train.resume_parity``, all five legs. Each leg runs
the same FCPR problem twice:

  * **uninterrupted** — the reference trajectory to S steps;
  * **killed** — run to step k, write a full-engine checkpoint
    (``train.checkpoints.save_engine``: a real ``.npz`` on disk), throw
    everything away, build fresh params, state and policy state, restore
    into them (in place) and run the remaining steps.

and demands that the final params, the whole ISGD state (rule state, ψ
queue, counters) and, for ``sched``, the policy table agree exactly (max
abs deviation 0.0). The problem has an outlier batch, so the accelerate
branch fires on both sides of the kill, and a ψ̄-dependent LR, so a resume
that lost the queue would take a wrong LR at once.

Legs:

  * ``per-step`` — ``make_train_step``; killed at k=10 of S=30;
  * ``chunked`` — the fused engine killed at a K=3 chunk boundary (step 6)
    and resumed with K=4, so step 6 is mid-chunk on the resumed grid
    (``ChunkFn``'s ``j0`` is a free cursor). The reference is the port's
    own *per-step* engine, bit for bit: resume parity composes with engine
    parity. (The JAX package's fused leg is not bit-exact with its own
    per-step engine on XLA:CPU in every version, so it is no reference.)
  * ``sched`` — the fused engine under ``loss-prop``, the EMA table in the
    checkpoint;
  * ``hybrid`` — the data-parallel engine (``repro_torch.distributed``,
    the reference's hybrid engine on a data-only mesh) across the process
    group (a one-rank group made for the leg when none exists), each rank on
    its rows; the checkpoint is written by rank 0 and validated by every
    other rank (``Checkpointer`` roles) in a directory rank 0 makes and
    shares, and every rank restores from it;
  * ``async-ps`` — the asynchronous parameter server
    (``repro_torch.distributed.async_ps``), one worker at staleness 0: the
    uninterrupted run doubles as the checkpoint writer (the server's
    in-lock ``checkpoint_fn`` takes the snapshot at version k, which pairs
    push k with its SSP clock), and a fresh coordinator resumes from the
    restored checkpoint (``snapshot_from_checkpoint``), replaying only the
    pushes after k.

    PYTHONPATH=src python -m repro_torch.train.resume_parity [--device cpu]
    PYTHONPATH=src python -m repro_torch.train.resume_parity --device cpu \
        --procs 2               # the hybrid leg across two spawned ranks

Exit 0 iff every leg is bit-exact, 2 if the subproblem never fired.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import ISGDConfig
from repro_torch.data import DeviceRing, FCPRSampler
from repro_torch.device import resolve_device
from repro_torch.optim import momentum
from repro_torch.train import checkpoints
from repro_torch.train.trainer import host_metrics

LAYOUT = checkpoints.named_layout(["w", "b"])


def _problem(device, batch_size: int = 32, n_batches: int = 4):
    """Least squares with one outlier batch (the reference's rig): the
    outlier breaks ψ̄ + kσ every cycle after warm-up. Returns ``(make,
    sampler, icfg, rule, lr_fn)``; ``make()`` -> fresh ``(params,
    loss_fn)``."""
    dim = 6
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

    # ψ̄-dependent LR on purpose: a resume that loses the queue would pick a
    # wrong LR on its first step and diverge from the reference at once
    def lr_fn(psi_bar):
        return 0.01 + 0.001 * torch.clamp(psi_bar, max=1.0)

    return make, sampler, icfg, momentum(0.9), lr_fn


def _max_dev(a, b) -> float:
    """Largest |a − b| over two trees of tensors, arrays and numbers."""
    if isinstance(a, dict):
        return max((_max_dev(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)):
        return max((_max_dev(x, y) for x, y in zip(a, b)), default=0.0)
    if a is None:
        return 0.0
    x = torch.as_tensor(a).detach().double().cpu()
    y = torch.as_tensor(b).detach().double().cpu()
    if x.numel() == 0:
        return 0.0
    diff = (x - y).abs()
    # equal infinities (the warm-up limit) deviate by 0
    diff[(x == y)] = 0.0
    return float(diff.max())


def _state(state):
    """The ISGD state without the device form's Alg. 2 scratch."""
    return tuple(state)[:5]


def _leg(name: str, ref, resumed, accelerations: int) -> dict:
    dev = max(_max_dev(r, g) for r, g in zip(ref, resumed))
    return {"leg": name, "ok": dev == 0.0, "max_dev": dev,
            "accelerations": accelerations}


def _leg_per_step(tmp: str, S: int, k: int, device) -> dict:
    from repro_torch.train.trainer import make_train_step
    make, sampler, icfg, rule, lr_fn = _problem(device)

    def batch(j):
        return {n: torch.from_numpy(v).to(device)
                for n, v in sampler(j).items()}

    def run(j0, j1, ckpt=None):
        params, loss_fn = make()
        init_fn, step = make_train_step(loss_fn, rule, icfg, lr_fn=lr_fn)
        state = init_fn(params)
        if ckpt is not None:                 # fresh templates, in place
            state = checkpoints.restore_engine(
                ckpt, params_like=params, state_like=state,
                layout=LAYOUT).state
        accel = 0
        for j in range(j0, j1):
            state, params, m = step(state, params, batch(j))
            accel += int(m["accelerated"])
        return params, state, accel

    params, state, a_ref = run(0, S)
    pr, st, _ = run(0, k)
    path = checkpoints.save_engine(os.path.join(tmp, "per_step"), params=pr,
                                   state=st, step=k, layout=LAYOUT)
    pr2, st2, _ = run(k, S, ckpt=path)
    return _leg("per-step", (params, _state(state)), (pr2, _state(st2)),
                a_ref)


def _leg_chunked(tmp: str, S: int, k: int, device) -> dict:
    from repro_torch.train.chunked import make_chunked_train_step
    from repro_torch.train.trainer import make_train_step
    make, sampler, icfg, rule, lr_fn = _problem(device)
    assert k % 3 == 0 and (S - k) % 4 == 0 and k % 4 != 0, (S, k)
    ring = DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                      device=device)

    # reference: the PER-STEP engine (module doc)
    params, loss_fn = make()
    init_fn, step = make_train_step(loss_fn, rule, icfg, lr_fn=lr_fn)
    state = init_fn(params)
    a_ref = 0
    for j in range(S):
        state, params, m = step(state, params, ring(j))
        a_ref += int(m["accelerated"])

    def chunked(K):
        p, lf = make()
        init, chunk = make_chunked_train_step(lf, rule, icfg, chunk_steps=K,
                                              lr_fn=lr_fn)
        return p, init(p), chunk

    pr, st, chunk3 = chunked(3)
    for c in range(k // 3):
        st, pr, _ = chunk3(st, pr, ring.arrays, c * 3)
    path = checkpoints.save_engine(os.path.join(tmp, "chunked"), params=pr,
                                   state=st, step=k, layout=LAYOUT)
    pr2, st2, chunk4 = chunked(4)
    ck = checkpoints.restore_engine(path, params_like=pr2, state_like=st2,
                                    layout=LAYOUT)
    # resume with K=4: step 6 sits MID-chunk on this grid (6 % 4 = 2)
    for c in range((S - ck.step) // 4):
        st2, pr2, _ = chunk4(st2, pr2, ring.arrays, ck.step + c * 4)
    return _leg("chunked", (params, _state(state)), (pr2, _state(st2)),
                a_ref)


def _leg_sched(tmp: str, S: int, k: int, device) -> dict:
    from repro_torch.sched import schedule_from_spec
    from repro_torch.train.chunked import make_chunked_train_step
    make, sampler, icfg, rule, lr_fn = _problem(device)
    K = 3
    assert k % K == 0 and S % K == 0, (S, k, K)
    schedule = schedule_from_spec("loss-prop")
    ring = DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                      device=device)

    def fresh():
        p, lf = make()
        init, chunk = make_chunked_train_step(lf, rule, icfg, chunk_steps=K,
                                              lr_fn=lr_fn, schedule=schedule)
        return p, init(p), schedule.init(icfg.n_batches, device=device), chunk

    def run(params, state, sched_state, chunk, c0, c1):
        accel = 0
        for c in range(c0, c1):
            state, params, sched_state, ms = chunk(
                state, params, sched_state, ring.arrays, c * K)
            accel += int(host_metrics(ms)["accelerated"].sum())
        return params, state, sched_state, accel

    params, state, sch, a_ref = run(*fresh(), 0, S // K)
    pr, st, s1, _ = run(*fresh(), 0, k // K)
    path = checkpoints.save_engine(os.path.join(tmp, "sched"), params=pr,
                                   state=st, sched_state=s1, step=k,
                                   layout=LAYOUT)
    pr2, st2, s2, chunk = fresh()
    ck = checkpoints.restore_engine(path, params_like=pr2, state_like=st2,
                                    sched_like=s2, layout=LAYOUT)
    pr2, st2, s2, _ = run(pr2, st2, s2, chunk, ck.step // K, S // K)
    return _leg("sched", (params, _state(state), sch),
                (pr2, _state(st2), s2), a_ref)


def _leg_hybrid(S: int, k: int, device, backend=None) -> dict:
    import shutil

    import torch.distributed as dist

    from repro_torch.distributed import batch_sharding, make_hybrid_step
    from repro_torch.launch import env
    from repro_torch.launch.mesh import make_host_mesh
    make, sampler, icfg, rule, lr_fn = _problem(device)
    with env.local_group(device, backend):
        mesh = make_host_mesh(model=1, device=device.type, backend=backend)
        cut = batch_sharding(mesh)

        def run(j0, j1, ck=None):
            params, loss_fn = make()
            init_fn, step = make_hybrid_step(loss_fn, rule, icfg, mesh,
                                             lr_fn=lr_fn)
            state = init_fn(params)
            if ck is not None:                 # fresh templates, in place
                state = checkpoints.restore_engine(
                    ck, params_like=params, state_like=state,
                    layout=LAYOUT).state
            accel = 0
            for j in range(j0, j1):
                batch = {n: torch.from_numpy(v).to(device)
                         for n, v in cut(sampler(j)).items()}
                state, params, m = step(state, params, batch)
                accel += int(m["accelerated"])
            return params, state, accel

        # one directory for every rank: rank 0 makes it and shares its name
        name = [tempfile.mkdtemp(prefix="resume_hybrid_")
                if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(name, src=0)
        try:
            params, state, a_ref = run(0, S)
            pr, st, _ = run(0, k)
            ckpt = checkpoints.Checkpointer(name[0], layout=LAYOUT)
            path = ckpt.save(k, params=pr, state=st)
            pr2, st2, _ = run(k, S, ck=path)
            dist.barrier()                     # every rank restored
        finally:
            if dist.get_rank() == 0:
                shutil.rmtree(name[0], ignore_errors=True)
    return _leg("hybrid", (params, _state(state)), (pr2, _state(st2)),
                a_ref)


def _leg_async_ps(tmp: str, S: int, k: int, device) -> dict:
    from repro_torch.core.isgd import isgd_init
    from repro_torch.distributed.async_ps.coordinator import (
        AsyncPSCoordinator, snapshot_engine_kwargs, snapshot_from_checkpoint)
    make, sampler, icfg, rule, lr_fn = _problem(device)

    def coord():
        return AsyncPSCoordinator(lambda w: make(), rule, icfg, workers=1,
                                  max_staleness=0, lr_fn=lr_fn)

    # the uninterrupted run doubles as the checkpoint writer: the server's
    # in-lock checkpoint_fn fires at version k (crash consistency — the
    # snapshot pairs push k with its SSP clock); the server never writes a
    # tensor it handed out, so the snapshot is still version k's after
    # the run
    snaps = []
    params0, _ = make()
    c1 = coord()
    c1.warmup(params0, sampler)
    params, state, records = c1.run(params0, sampler, S,
                                    checkpoint_fn=snaps.append,
                                    checkpoint_every=k)
    snap = next(s for s in snaps if s["version"] == k)
    path = checkpoints.save_engine(os.path.join(tmp, "async_ps"),
                                   layout=LAYOUT,
                                   **snapshot_engine_kwargs(snap))
    fresh, _ = make()
    ck = checkpoints.restore_engine(
        path, params_like=fresh, state_like=isgd_init(rule, icfg, fresh),
        layout=LAYOUT)
    assert ck.server == {"version": k, "pushed": {0: k}}, ck.server
    params2, state2, rec2 = coord().run(fresh, sampler, S,
                                        resume=snapshot_from_checkpoint(ck))
    a_ref = sum(int(r["accelerated"]) for r in records)
    r = _leg("async-ps", (params, _state(state)), (params2, _state(state2)),
             a_ref)
    r["resumed_pushes"] = len(rec2)            # only the replayed tail
    return r


LEGS = ("per-step", "chunked", "sched", "hybrid", "async-ps")


def run_resume_parity(S: int = 30, k: int = 10, *, legs=LEGS,
                      device="cuda", backend=None) -> list:
    """One result dict per leg: {"leg", "ok", "max_dev", "accelerations"};
    ``ok`` means bit-exact (max_dev == 0.0). ``backend`` is the hybrid
    leg's, where it makes its group."""
    dev = resolve_device(device)
    runners = {"per-step": lambda t: _leg_per_step(t, S, k, dev),
               "chunked": lambda t: _leg_chunked(t, S, 6, dev),
               "sched": lambda t: _leg_sched(t, S, max(3, k - k % 3), dev),
               "hybrid": lambda t: _leg_hybrid(S, k, dev, backend),
               "async-ps": lambda t: _leg_async_ps(t, S, k, dev)}
    unknown = set(legs) - set(runners)
    if unknown:
        raise ValueError(f"legs {sorted(unknown)} are not ported yet "
                         f"(have {LEGS})")
    with tempfile.TemporaryDirectory(prefix="resume_parity_") as tmp:
        return [runners[leg](tmp) for leg in legs]


def _rank(rank, world, S, k, device):
    """``spawn_ranks`` target: the hybrid leg on one rank."""
    return run_resume_parity(S, k, legs=("hybrid",), device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--kill-at", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=1,
                    help="> 1: the hybrid leg across this many spawned ranks")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    args = ap.parse_args(argv)
    if args.procs > 1:
        from repro_torch.launch.env import spawn_ranks
        ranks = spawn_ranks(_rank, args.procs, args.steps, args.kill_at,
                            args.device, device=args.device,
                            backend=args.backend)
        results = [dict(ranks[0][0], ok=all(r[0]["ok"] for r in ranks))]
    else:
        results = run_resume_parity(args.steps, args.kill_at,
                                    device=args.device, backend=args.backend)
    fired = 0
    for r in results:
        fired += r["accelerations"]
        print(f"resume-parity {r['leg']:>8s}: "
              f"max_dev={r['max_dev']:.3e} "
              f"accelerations={r['accelerations']} -> "
              f"{'BIT-EXACT' if r['ok'] else 'FAIL'}")
    if fired == 0:
        print("resume-parity WARNING: subproblem never fired; the "
              "accelerate branch never crossed a kill boundary")
        return 2
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
