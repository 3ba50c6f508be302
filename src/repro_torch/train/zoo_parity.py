"""Zoo parity matrix: the fused engines re-proven on the zoo's step bodies.

Port of ``repro.train.zoo_parity``, with the reference's leg names:

  * ``{model}:chunked-K{k}``: the per-step ``make_train_step`` against the
    fused ``make_chunked_train_step`` at K ∈ {1, K} on
    ``paper-transformer-tiny`` and at K on the MoE and SSM bodies: params,
    metrics and acceleration counts bit for bit;
  * ``transformer:frozen-lr-differs``: every leg drives a ψ̄-dependent
    ``lr_fn``; the reference re-run with the LR frozen at ``lr_fn(0.0)``
    must differ, so the matrix can catch a dropped ψ̄ schedule;
  * ``transformer:sched-fcpr-K{K}``: the fused leg with the batch drawn by
    the ``sched`` FCPR policy, bit for bit;
  * ``transformer:hybrid(n,1)-chunked-K{K}``: per-step against fused of
    the hybrid engine on an ``(n, 1)`` mesh, over ``n`` spawned ranks
    (``--procs``; gloo on the CPU, NCCL on the card), bit for bit;
  * ``{model}:kernels-interpret-vs-ref``: the kernel build against the
    reference build, loss within the f32 tolerance of the model's kernels
    (``kernels.numerics.TOLERANCES``) and gradients within 10× it, in f32.
    The reference runs its Pallas kernels in interpret mode there; the
    port's counterpart on the CPU is ``kernels="cuda"``, whose wrappers
    compute their plain versions on CPU tensors, against the models' own
    paths. On the card the leg is ``{model}:kernels-cuda-vs-ref``: the
    CUDA kernels against the reference build.

The bit-exact legs use the reference build in bf16 (the reference's
choice). Data is a skewed FCPR epoch (batch 0 uniform random tokens, the
rest repeated 4-grams), so the subproblem fires.

    PYTHONPATH=src python -m repro_torch.train.zoo_parity --device cpu \\
        --procs 2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

N_BATCHES, BATCH, SEQ = 4, 8, 64
KEYS = ("loss", "limit", "psi_bar", "accelerated", "sub_iters")
KERNELS_BY_MODEL = {"transformer": ("flash_attention", "fused_xent"),
                    "moe": ("flash_attention", "fused_xent"),
                    "ssm": ("ssd_scan", "fused_xent")}


def _lr_fn(psi_bar):
    # ψ̄-dependent on purpose: freezing ψ̄=0 shifts the whole trajectory
    return 0.05 + 0.005 * torch.clamp(psi_bar, max=1.0)


def skewed_epoch(vocab: int, rng) -> np.ndarray:
    """Batch 0 uniform-random (hard), the rest repeated 4-grams (easy)."""
    hard = rng.randint(0, vocab, size=(BATCH, SEQ))
    base = rng.randint(0, vocab, size=(3, 4))
    easy = np.stack([np.tile(base[i % 3], (BATCH, SEQ // 4))
                     for i in range(N_BATCHES - 1)])
    return np.concatenate([hard[None], easy], 0).reshape(-1, SEQ) \
        .astype(np.int32)


def _setup(name: str, seed_rng, dev, kernels="reference",
           dtype=torch.bfloat16):
    from repro_torch.configs import zoo_config
    from repro_torch.data import FCPRSampler
    from repro_torch.models import build_model
    cfg = zoo_config(name, "tiny")
    model = build_model(cfg, kernels=kernels, param_dtype=dtype, device=dev)
    model.init(0, max_seq=SEQ)
    toks = skewed_epoch(cfg.vocab_size, seed_rng)
    sampler = FCPRSampler({"tokens": toks}, batch_size=BATCH, seed=1)
    return model, sampler


def _result(params, state, rows):
    log = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    return ([p.detach().float().cpu().numpy().copy() for p in params],
            int(state.accel_count), log)


def _drive(step_fn, init_fn, params, sampler, steps, dev):
    from repro_torch.train import host_metrics
    state, rows = init_fn(params), []
    for j in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in sampler(j).items()}
        state, params, m = step_fn(state, params, batch)
        rows.append({k: v[None] for k, v in host_metrics(m).items()})
    return _result(params, state, rows)


def _drive_chunked(chunk_fn, init_fn, params, ring, steps, k, sched=None):
    from repro_torch.train import host_metrics
    state, rows = init_fn(params), []
    ss = None if sched is None else sched.init(N_BATCHES,
                                               device=ring.device)
    for c in range(steps // k):
        if sched is None:
            state, params, ms = chunk_fn(state, params, ring.arrays, c * k)
        else:
            state, params, ss, ms = chunk_fn(state, params, ss, ring.arrays,
                                             c * k)
        rows.append(host_metrics(ms))
    return _result(params, state, rows)


def _bit_exact(ref, got):
    dev_ = max(float(np.max(np.abs(a - b))) for a, b in zip(ref[0], got[0]))
    ok = all(np.array_equal(ref[2][k], got[2][k]) for k in KEYS)
    return bool(ok and dev_ == 0.0 and ref[1] == got[1]), dev_


def _hybrid_leg(rank, world, steps, K, device):
    """``spawn_ranks`` target: the transformer body per-step against fused
    on the ``(n, 1)`` mesh of the group."""
    from repro_torch.core import ISGDConfig
    from repro_torch.data import DeviceRing
    from repro_torch.device import resolve_device
    from repro_torch.distributed.data_parallel import (
        batch_sharding, make_chunked_hybrid_step, make_hybrid_step)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import momentum
    dev = resolve_device(device)
    mesh = make_host_mesh(model=1, device=dev.type)
    icfg = ISGDConfig(n_batches=N_BATCHES, k_sigma=1.0, stop=3, zeta=0.01)
    model, sampler = _setup("transformer", np.random.RandomState(0), dev)
    cut = batch_sharding(mesh)
    hinit, hstep = make_hybrid_step(model.loss_fn, momentum(0.9), icfg, mesh,
                                    lr_fn=_lr_fn)
    hy = _drive(hstep, hinit, model.params(), lambda j: cut(sampler(j)),
                steps, dev)
    model.init(0, max_seq=SEQ)
    ring = DeviceRing(sampler.epoch_arrays(), BATCH, mesh=mesh, axis=None)
    cinit, chunk = make_chunked_hybrid_step(
        model.loss_fn, momentum(0.9), icfg, mesh, chunk_steps=K,
        lr_fn=_lr_fn)
    got = _drive_chunked(chunk, cinit, model.params(), ring, steps, K)
    ok, d = _bit_exact(hy, got)
    return {"ok": ok, "max_param": d}


def run_zoo_parity(steps: int = 32, K: int = 32,
                   models: tuple = ("transformer", "moe", "ssm"),
                   device="cuda", procs: int = 1, backend=None,
                   timeout: float = 600.0, verbose: bool = False) -> dict:
    """-> {"ok", "devices", "steps", "K", "accelerations", "legs"}."""
    from repro_torch.core import ISGDConfig
    from repro_torch.data import DeviceRing
    from repro_torch.device import resolve_device
    from repro_torch.kernels.numerics import TOLERANCES
    from repro_torch.launch.env import spawn_ranks
    from repro_torch.optim import momentum
    from repro_torch.sched import FCPRSchedule
    from repro_torch.train import make_chunked_train_step, make_train_step

    dev = resolve_device(device)
    assert steps % K == 0 and steps >= 2 * N_BATCHES, (steps, K)
    assert BATCH % procs == 0, f"batch {BATCH} not divisible over {procs}"
    rule = momentum(0.9)
    icfg = ISGDConfig(n_batches=N_BATCHES, k_sigma=1.0, stop=3, zeta=0.01)
    legs, accels = {}, {}
    rng = np.random.RandomState(0)

    for name in models:
        model, sampler = _setup(name, rng, dev)

        def fresh():
            model.init(0, max_seq=SEQ)
            return model.params()

        init_fn, step = make_train_step(model.loss_fn, rule, icfg,
                                        lr_fn=_lr_fn)
        ref = _drive(step, init_fn, fresh(), sampler, steps, dev)
        accels[name] = int(ref[2]["accelerated"].sum())

        ring = DeviceRing(sampler.epoch_arrays(), BATCH, device=dev)
        for k in ((1, K) if name == "transformer" else (K,)):
            cinit, chunk = make_chunked_train_step(
                model.loss_fn, rule, icfg, chunk_steps=k, lr_fn=_lr_fn)
            ok, d = _bit_exact(ref, _drive_chunked(chunk, cinit, fresh(),
                                                   ring, steps, k))
            legs[f"{name}:chunked-K{k}"] = {"ok": ok, "max_param": d}
        if name != "transformer":
            continue

        finit, fstep = make_train_step(
            model.loss_fn, rule, icfg,
            lr_fn=lambda p: _lr_fn(torch.zeros_like(p)))
        frozen = _drive(fstep, finit, fresh(), sampler, steps, dev)
        legs["transformer:frozen-lr-differs"] = {
            "ok": any(not np.array_equal(a, b)
                      for a, b in zip(ref[0], frozen[0])), "max_param": None}

        fcpr = FCPRSchedule()
        cinit, chunk = make_chunked_train_step(
            model.loss_fn, rule, icfg, chunk_steps=K, lr_fn=_lr_fn,
            schedule=fcpr)
        ok, d = _bit_exact(ref, _drive_chunked(chunk, cinit, fresh(), ring,
                                               steps, K, fcpr))
        legs[f"transformer:sched-fcpr-K{K}"] = {"ok": ok, "max_param": d}

        res = spawn_ranks(_hybrid_leg, procs, steps, K, device,
                          device=device, backend=backend, timeout=timeout)
        legs[f"transformer:hybrid(n,1)-chunked-K{K}"] = {
            "ok": all(r["ok"] for r in res),
            "max_param": max(r["max_param"] for r in res)}

    # the kernel leg, in f32 (bf16 gradients quantize at ~3e-3 and would
    # swamp the kernel deviation being measured)
    mode = "cuda" if dev.type == "cuda" else "interpret"
    for name in models:
        ref_m, _ = _setup(name, np.random.RandomState(7), dev,
                          dtype=torch.float32)
        ker_m, _ = _setup(name, np.random.RandomState(7), dev,
                          kernels="cuda", dtype=torch.float32)
        ker_m.module.load_state_dict(ref_m.module.state_dict())
        from repro_torch.configs import zoo_config
        toks = skewed_epoch(zoo_config(name, "tiny").vocab_size,
                            np.random.RandomState(7))
        b = {"tokens": torch.from_numpy(toks[:2]).to(dev)}
        outs = []
        for m in (ref_m, ker_m):
            loss, _ = m.loss_fn(b)
            grads = torch.autograd.grad(loss, m.params())
            outs.append((float(loss.detach()), [g.detach().cpu().numpy()
                                       for g in grads]))
        tol = max(TOLERANCES[k]["float32"][0] for k in KERNELS_BY_MODEL[name])
        l_dev = abs(outs[0][0] - outs[1][0])
        g_dev = max(float(np.max(np.abs(a - b_)))
                    for a, b_ in zip(outs[0][1], outs[1][1]))
        legs[f"{name}:kernels-{mode}-vs-ref"] = {
            "ok": l_dev <= tol and g_dev <= 10 * tol, "max_param": g_dev,
            "loss_dev": l_dev, "tol": tol}

    ok = all(leg["ok"] for leg in legs.values())
    if verbose:
        for name, leg in legs.items():
            print(f"  {name:38s} ok={leg['ok']} max_param={leg['max_param']}")
    return {"ok": ok, "devices": procs, "steps": steps, "K": K,
            "accelerations": accels, "legs": legs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=1,
                    help="ranks of the hybrid (n, 1) leg, one process each "
                         "(the reference's --devices)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--chunk-steps", type=int, default=32)
    ap.add_argument("--models", default="transformer,moe,ssm",
                    help="comma-separated subset of the zoo")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    resolve_device(args.device)
    r = run_zoo_parity(steps=args.steps, K=args.chunk_steps,
                       models=tuple(args.models.split(",")),
                       device=args.device, procs=args.procs,
                       backend=args.backend, verbose=args.verbose)
    bad = [n for n, leg in r["legs"].items() if not leg["ok"]]
    print(f"zoo-parity devices={r['devices']} steps={r['steps']} "
          f"K={r['K']} accelerations={r['accelerations']} "
          f"legs={len(r['legs'])} failed={bad or 'none'} -> "
          f"{'OK' if r['ok'] else 'FAIL'}")
    if r["accelerations"].get("transformer", 1) == 0:
        print("zoo-parity WARNING: subproblem never fired on transformer")
        return 2
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
