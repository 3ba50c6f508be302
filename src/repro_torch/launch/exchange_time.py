"""The data mean's exchange, timed on the cards: point-to-point against
``all_to_all_single``.

    PYTHONPATH=src python -m repro_torch.launch.exchange_time \
        [--ranks 1 2 4] [--n N] [--reps 20] [--device cuda|cpu]

``AxisReduce`` (``core/reduce.py``) sends each segment of its packed f32
bucket to the rank that reduces it. Over NCCL it does so by
``exchange_p2p`` (a copy of the rank's own segment and one batch of sends
and receives), over gloo by ``exchange_a2a`` (one ``all_to_all_single``).
For each world size W of ``--ranks``, one rank a card, this times both
forms on one bucket of ``--n`` f32 elements split as the pure
data-parallel engine splits it (``_Plan``), and the whole reduction
(exchange, rank-order mean, gather of the means: ``AxisReduce._run``).
Each is timed by CUDA events around one call, after a barrier and a
synchronisation, ``--reps`` times, the forms in turn; the first call of
each is a warm-up and is not kept. The two forms must receive the same
bits, every rank's segment in rank order, and the run fails otherwise. Prints one JSON line a world size:
each rank's median ms of each form, the slowest rank's, and the GB/s that
a rank sends at that median ((W − 1)/W of the bucket).

The default ``--n`` is ``paper-transformer`` base's bucket: its
318,800,896 parameters plus ψ and aux, 1,275,203,592 bytes, as
``chip_smoke.py``'s ``dp2`` phase reports it. ``--device cpu`` runs the
same over gloo on CPU tensors, to check the script, not to time a card.
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

PAPER_TRANSFORMER_BUCKET = 318_800_898     # f32 elements: parameters, ψ, aux
FORMS = ("p2p", "a2a", "reduction")


def exchange_rank(rank: int, world: int, n: int, reps: int) -> dict:
    """One rank: the bucket, both exchanges and the whole reduction timed
    ``reps`` times each -> {"ms": {form: [ms, ...]}, "same_bits": bool}."""
    import time

    import torch.distributed as dist

    from repro_torch.core.reduce import AxisReduce, exchange_a2a, exchange_p2p
    cuda = dist.get_backend() == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    ctx = AxisReduce("data", deterministic=True)
    plan = ctx._plan([(n,)], None, dev)
    gen = torch.Generator(device=dev).manual_seed(rank)
    bucket = torch.rand(n, generator=gen, device=dev)
    got = torch.empty_like(plan.received())
    alt = torch.empty_like(got)

    def run(form):
        if form == "p2p":
            exchange_p2p(bucket, got, plan.sizes)
        elif form == "a2a":
            exchange_a2a(bucket, alt, plan.sizes)
        else:
            plan.flat.copy_(bucket)
            ctx._run(plan)

    ms = {f: [] for f in FORMS}
    for i in range(reps + 1):
        for form in FORMS:
            dist.barrier()
            if cuda:
                torch.cuda.synchronize()
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                run(form)
                b.record()
                b.synchronize()
                t = a.elapsed_time(b)
            else:
                t0 = time.perf_counter()
                run(form)
                t = (time.perf_counter() - t0) * 1e3
            if i:
                ms[form].append(t)
    lo = sum(plan.sizes[:rank])
    in_order = all(torch.equal(got[q], torch.rand(
        n, generator=gen.manual_seed(q), device=dev)[lo:lo + plan.mine])
        for q in range(world))
    return {"ms": ms, "same_bits": bool(torch.equal(got, alt)) and in_order}


def time_world(world: int, n: int, reps: int, device: str) -> dict:
    """``exchange_rank`` on ``world`` fresh ranks -> the summary line."""
    from repro_torch.launch.env import spawn_ranks
    ranks = spawn_ranks(exchange_rank, world, n, reps, device=device,
                        timeout=600)
    sent = 4 * n * (world - 1) / world
    out = {"ranks": world, "n": n, "bucket_bytes": 4 * n, "reps": reps,
           "device": device,
           "same_bits": all(r["same_bits"] for r in ranks)}
    if device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    for form in FORMS:
        med = [statistics.median(r["ms"][form]) for r in ranks]
        out[form] = {"median_ms_by_rank": med, "slowest_ms": max(med),
                     "min_ms": min(min(r["ms"][form]) for r in ranks)}
        if form != "reduction" and world > 1:
            out[form]["send_gbps"] = sent / max(med) / 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--n", type=int, default=PAPER_TRANSFORMER_BUCKET)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        have = torch.cuda.device_count()
        if max(args.ranks) > have:
            raise SystemExit(f"--ranks {max(args.ranks)} needs as many "
                             f"cards; {have} found")
    ok = True
    for world in args.ranks:
        line = time_world(world, args.n, args.reps, args.device)
        ok &= line["same_bits"]
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
