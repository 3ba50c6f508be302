"""Serving launcher: one-shot batched generate, or the continuous-batching
slot engine with hot snapshot swap (train-and-serve).

Port of ``repro.launch.serve``. The request set is the reference's
``workload`` (``RandomState(0)``), so both launchers serve the same
prompts. Serving runs the model's plain paths under either ``--kernels``
choice, as the reference serves without its Pallas kernels; on a CUDA
device the continuous engine's decode step is one CUDA graph, captured in
the warm-up and replayed for every step after it.

One-shot (the whole batch prefilled together; decode blocks until every
row finishes):

  PYTHONPATH=src python -m repro_torch.launch.serve --model transformer \\
      --tier base --engine oneshot --batch 16 --prompt-len 512 \\
      --decode-steps 64 --max-seq 1024

Continuous batching (request-level admission into preallocated KV slots;
``repro_torch.serve.scheduler``):

  PYTHONPATH=src python -m repro_torch.launch.serve --model transformer \\
      --tier base --requests 48 --mixed-lengths --prompt-len 128 \\
      --decode-steps 64 --max-seq 1024 --max-batch 16

Train-and-serve, beside a trainer publishing snapshots:

  PYTHONPATH=src python -m repro_torch.launch.train --model transformer \\
      --steps 200 --publish-dir /tmp/pub --publish-every 20 &
  PYTHONPATH=src python -m repro_torch.launch.serve --model transformer \\
      --watch --publish-dir /tmp/pub --requests 32

``--watch`` blocks until the first published snapshot, then hot-swaps each
newer one between decode steps (in-flight requests keep their KV; each
completion records the snapshot generations that served it). The trainer
and the server must agree on ``--precision``. On the CPU add ``--device
cpu``; without it and without a card the launcher exits nonzero. Timed
throughput excludes the warm-up (first calls and the graph capture),
whose wall is reported separately.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ZOO_MODELS, ZOO_TIERS, get_config, zoo_config
from repro_torch.device import resolve_device
from repro_torch.kernels import KERNEL_CHOICES
from repro_torch.models import build_model
from repro_torch.obs.stats import percentile
from repro_torch.obs.timing import maybe_profile
from repro_torch.serve import (ContinuousScheduler, Request, ServeEngine,
                               SnapshotWatcher)
from repro_torch.train.checkpoints import layout_for

KERNELS_NOTE = ("serving runs the model's plain paths under either --kernels "
                "choice (the reference serves without its Pallas kernels): "
                "kernels={}")


def build_cfg(args):
    if (args.arch is None) == (args.model is None):
        raise SystemExit("pass exactly one of --arch or --model")
    if args.model is not None:
        if args.reduced:
            raise SystemExit("--reduced applies to --arch configs; the zoo "
                             "CPU tier is --tier tiny")
        return zoo_config(args.model, args.tier)
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def workload(args, vocab: int) -> list:
    """Deterministic request set, the reference's. ``--mixed-lengths``
    varies prompt length and token budget 4x (the regime where
    request-level batching beats the batch-blocking one-shot engine)."""
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(args.requests):
        if args.mixed_lengths:
            plen = args.prompt_len * (1, 2, 4)[i % 3]
            steps = max(1, args.decode_steps * (4, 1, 2)[i % 3] // 4)
        else:
            plen, steps = args.prompt_len, args.decode_steps
        prompt = rng.randint(0, vocab, size=(plen,)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=steps))
    return reqs


def run_oneshot(args, cfg, model, params) -> dict:
    engine = ServeEngine(model, params, max_seq=args.max_seq)
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)
    # warm-up: the timed run's shapes, so the timed wall is all serving
    t0 = time.perf_counter()
    engine.generate(prompts, steps=args.decode_steps)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = engine.generate(prompts, steps=args.decode_steps)
    dt = time.perf_counter() - t0
    n_tok = args.decode_steps * args.batch
    print(f"arch={cfg.name} engine=oneshot batch={args.batch} "
          f"prompt={args.prompt_len} decoded={args.decode_steps}")
    print(f"warm-up: {warm_s:.2f}s (excluded from tok/s)")
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok/dt:.1f} tok/s)")
    print("sample continuation:", out[0, args.prompt_len:
                                      args.prompt_len + args.decode_steps])
    return {"tokens": n_tok, "seconds": dt, "warmup_seconds": warm_s,
            "out": out}


def run_continuous(args, cfg, model, params, watcher, recorder=None) -> dict:
    reqs = workload(args, cfg.vocab_size)
    sched = ContinuousScheduler(
        model, params, max_batch=args.max_batch, max_seq=args.max_seq,
        max_decode_batch=args.max_decode_batch, max_queue=args.max_queue,
        watcher=watcher, swap_poll_every=args.swap_poll_every,
        recorder=recorder)
    # warm-up on the same scheduler (the decode graph is per SlotKV): one
    # request of each prompt length, two tokens each
    t0 = time.perf_counter()
    plens = sorted({len(r.prompt) for r in reqs})
    sched.warmup([Request(rid=-1 - i, prompt=np.zeros(p, np.int32),
                          max_new_tokens=2) for i, p in enumerate(plens)])
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    comps = sched.run(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in comps)
    lat = [t for c in comps for t in c.token_times[1:]]   # steady-state gaps
    gens = sorted({c.gen_finished for c in comps})
    print(f"arch={cfg.name} engine=continuous requests={len(reqs)} "
          f"max_batch={args.max_batch} "
          f"max_decode_batch={sched.max_decode_batch}")
    print(f"warm-up: {warm_s:.2f}s (excluded from tok/s) "
          f"compile_counts={sched.kv.compile_counts()}")
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok/dt:.1f} tok/s)  "
          f"per-token latency p50={percentile(lat, 50)*1e3:.1f}ms "
          f"p95={percentile(lat, 95)*1e3:.1f}ms")
    print(f"snapshot generations served: {gens or [0]} "
          f"(swaps: {len(sched.swap_events)})")
    for ev in sched.swap_events:
        print(f"  swap @step {ev.step}: generation {ev.generation} "
              f"(trainer step {ev.trainer_step}, load {ev.load_seconds:.2f}s)")
    if recorder is not None:
        recorder.event("serve.summary", tokens=n_tok, wall_s=dt,
                       tokens_per_s=n_tok / dt if dt else 0.0,
                       compile_s=warm_s, **sched.latency_summary())
        recorder.flush()
    print("sample continuation:", np.asarray(comps[0].tokens))
    return {"tokens": n_tok, "seconds": dt, "warmup_seconds": warm_s,
            "completions": comps, "scheduler": sched}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="assigned architecture config (repro_torch.configs)")
    ap.add_argument("--model", default=None, choices=list(ZOO_MODELS),
                    help="paper_transformer zoo family (alternative to "
                         "--arch)")
    ap.add_argument("--tier", default="tiny", choices=list(ZOO_TIERS))
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-size variant of --arch")
    ap.add_argument("--kernels", default="cuda", choices=list(KERNEL_CHOICES),
                    help="the training kernel mode; serving runs the plain "
                         "paths under either choice")
    ap.add_argument("--precision", default="bf16", choices=["bf16", "f32"],
                    help="param/compute dtype; must match the trainer's "
                         "when restoring published snapshots")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when named")
    ap.add_argument("--engine", default="continuous",
                    choices=["oneshot", "continuous"],
                    help="oneshot = batch-blocking generate; continuous = "
                         "slot-based continuous batching")
    ap.add_argument("--batch", type=int, default=4,
                    help="oneshot: rows per generate call")
    ap.add_argument("--requests", type=int, default=16,
                    help="continuous: workload size")
    ap.add_argument("--mixed-lengths", action="store_true",
                    help="continuous: vary prompt length and token budget "
                         "4x across requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16,
                    help="new tokens per request (max_new_tokens)")
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="continuous: preallocated KV slots")
    ap.add_argument("--max-decode-batch", type=int, default=0,
                    help="continuous: admission-control cap on concurrently "
                         "decoding requests (0 = max-batch)")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="continuous: bounded request backlog; submits "
                         "beyond it are shed")
    ap.add_argument("--watch", action="store_true",
                    help="poll --publish-dir and hot-swap each newer "
                         "snapshot between decode steps")
    ap.add_argument("--publish-dir", default=None)
    ap.add_argument("--watch-timeout", type=float, default=120.0,
                    help="seconds to wait for the first published snapshot")
    ap.add_argument("--swap-poll-every", type=int, default=8,
                    help="decode steps between watcher polls")
    ap.add_argument("--obs-dir", default=None,
                    help="write structured metrics/event JSONL here "
                         "(repro_torch.obs; admit/retire/swap events, "
                         "token-gap histograms, final latency summary)")
    ap.add_argument("--obs-console-every", type=int, default=0,
                    help="with --obs-dir: also print a console metrics "
                         "line at flush boundaries (0 = off)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the serve run "
                         "into this directory")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    print(KERNELS_NOTE.format(args.kernels), flush=True)
    cfg = build_cfg(args)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:                           # the CLI boundary
        raise SystemExit(f"error: {e}") from None
    if args.watch:
        if not args.publish_dir:
            raise SystemExit("--watch needs --publish-dir")
        if args.engine != "continuous":
            raise SystemExit("--watch requires --engine continuous (the "
                             "one-shot engine has no between-step swap "
                             "point)")
    dtype = torch.float32 if args.precision == "f32" else torch.bfloat16
    model = build_model(cfg, kernels=args.kernels, param_dtype=dtype,
                        device=dev)
    model.init(0, max_seq=args.max_seq)
    params = model.params()

    recorder = None
    if args.obs_dir:
        from repro_torch.obs import (ConsoleSink, JsonlSink, MetricsRecorder,
                                     jsonl_path)
        sinks = [JsonlSink(jsonl_path(args.obs_dir, 0))]
        if args.obs_console_every:
            sinks.append(ConsoleSink(every=args.obs_console_every,
                                     step_counter="serve/retired"))
        recorder = MetricsRecorder(
            sinks, tags={"process_id": 0, "engine": f"serve-{args.engine}",
                         "model": cfg.name})

    watcher = None
    if args.watch:
        watcher = SnapshotWatcher(args.publish_dir, params,
                                  layout=layout_for(model.module),
                                  recorder=recorder)
        snap = watcher.wait_for_first(timeout=args.watch_timeout)
        params = snap.params
        print(f"serving snapshot generation {snap.generation} "
              f"(trainer step {snap.step}, {snap.path})")

    with maybe_profile(args.profile_dir):
        if args.engine == "oneshot":
            res = run_oneshot(args, cfg, model, params)
        else:
            res = run_continuous(args, cfg, model, params, watcher,
                                 recorder=recorder)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if recorder is not None:
        from repro_torch.obs import write_merged_summary
        recorder.close()
        write_merged_summary(args.obs_dir)
        print(f"obs: {args.obs_dir}")
    return dict(res, model=model)


if __name__ == "__main__":
    main()
