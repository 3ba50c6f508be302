"""Production-mesh dry-run and roofline of the training step, on the meta
device.

Port of ``repro.launch.dryrun``, training half. The reference lowers and
compiles each (architecture × input shape × mesh) step against 512 forced
host devices and reads XLA's cost and memory analyses. The port has no
compiler: it runs rank 0's step of the hybrid engine
(``distributed.data_parallel``, parameters placed by
``launch.shardings.hybrid_params_placement``) on meta tensors, inside a
fake 256- or 512-rank process group (``launch.mesh.make_production_mesh``),
and counts what it dispatches (``analysis.count.CostCount``). Rank 0's
program stands for every rank's, as in SPMD. The step runs in analysis
mode (``analysis.mode``): the accelerate branch and exactly ``stop``
Alg. 2 trips, the paper's early-stopping upper bound, since a meta
predicate has no value to branch on.

  * ``--mode dryrun``: the full-depth step; memory per device (arguments:
    the rank's local shards of params, ISGD state and the batch it is
    handed; buffers: the gathered compute tensors and the reduction's
    buckets that the engine holds; temp: the peak of what the step
    allocates; out: what it leaves allocated), whether their sum fits
    the card's 80 GB (``fits=`` on the PASS line: a PASS says the step
    ran, not that a card can hold it; the buffers split into gathered
    parameters and the reduction's), per-device GFLOP, GB and
    collective GB, the roofline; a JSON record in ``experiments/dryrun/``;
  * ``--mode analysis``: the reference's two-point extrapolation over the
    layer blocks (k = 1, 2), which is exact because every block dispatches
    the same ops; a JSON record in ``experiments/roofline/``.

The serving shapes (``prefill_32k``, ``decode_32k``, ``long_500k``),
``--cache-shard batch`` and ``--remat-policy tp_out`` raise ``A17bError``:
they need ``batch_shardings``, ``cache_shardings``, a tensor-parallel
prefill and decode, and the ``tp_out`` policy, none of which the port has
(slice A17b). ``--all`` lists those pairs as ``SKIP ... (A17b)``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k \\
      [--arch internlm2-1.8b] [--multi-pod] [--mode dryrun|analysis]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.analysis import roofline
from repro_torch.analysis.count import Collective, CostCount, Count
from repro_torch.analysis.mode import analysis_mode
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 shape_applicable)
from repro_torch.core import ISGDConfig
from repro_torch.core.reduce import tree_leaves
from repro_torch.core.schedule import constant_lr
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shardings import hybrid_params_placement
from repro_torch.models import build_model
from repro_torch.optim import momentum

A17B = ("slice A17b (the serving dry-runs: batch_shardings, "
        "cache_shardings, a tensor-parallel prefill and decode, "
        "--remat-policy tp_out), not ported yet")


class A17bError(NotImplementedError):
    """A dry-run the port cannot make before slice A17b."""


def refuse_a17b(shape=None, cache_shard="feature", remat_policy="full"):
    """Raise ``A17bError`` for what only slice A17b can run."""
    if shape is not None and shape.kind != "train":
        raise A17bError(f"the {shape.kind} shape {shape.name} needs {A17B}")
    if cache_shard != "feature":
        raise A17bError(f"--cache-shard {cache_shard} needs {A17B}")
    if remat_policy != "full":
        raise A17bError(f"--remat-policy {remat_policy} needs {A17B}")


def _mesh_name(mesh) -> str:
    return "x".join(f"{n}{a}" for n, a in zip(mesh.shape, mesh.mesh_dim_names))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@dataclasses.dataclass
class Step:
    """One rank's train step, ready to run: ``run()`` does one step;
    ``arg_bytes`` are the rank's local shards of params and state and the
    batch it is handed; the engine holds beside them ``gathered_bytes``
    (the compute tensors it gathers into, past the local shards) and
    ``reduce_bytes`` (the data mean's bucket and receive buffer)."""
    run: callable
    arg_bytes: int
    gathered_bytes: int
    reduce_bytes: int

    @property
    def buffer_bytes(self) -> int:
        """What the engine holds beside the arguments."""
        return self.gathered_bytes + self.reduce_bytes


def build_step(model, mesh, shape, *, inconsistent=True, fsdp=True,
               isgd_stop=5, cache_shard="feature", micro=1,
               batch=None) -> Step:
    """The hybrid engine's device-form step (momentum 0.9, ``n_batches``
    64, constant LR 0.01) at ``mesh``, fed ``batch`` (default
    ``model.input_specs(shape)``, meta tensors). On a mesh with a model
    axis past 1 it takes ``model``'s parameters placed by
    ``hybrid_params_placement``; on one without, replicated, as the
    launcher does."""
    from repro_torch.distributed.data_parallel import mesh_strategy
    from repro_torch.train.chunked import make_device_step
    refuse_a17b(shape, cache_shard)
    cfg = model.cfg
    model.init(0, max_seq=shape.seq_len if cfg.family == "encdec" else 4096)
    strat = mesh_strategy(mesh)
    gathered = 0
    if strat.tensor_parallel:
        local, placement = hybrid_params_placement(mesh, model.module,
                                                   fsdp=fsdp)
        gathered = placement.held_bytes()
    else:       # no model axis past 1: replicated, as the launcher runs it
        local = model.params()
    icfg = ISGDConfig(n_batches=64, stop=isgd_stop)
    init_fn, step_fn = make_device_step(
        lambda batch: model.loss_fn(batch), momentum(0.9), icfg,
        inconsistent=inconsistent, lr_fn=constant_lr(0.01),
        reduce_ctx=strat.reduce_ctx, micro_batches=micro)
    strat.bind(local)
    state = init_fn(local)
    strat.prime(local)
    if batch is None:
        batch = model.input_specs(shape)
    reduce_bytes = sum(getattr(strat.reduce_ctx, "buffer_bytes", {}).values())

    def run():
        return step_fn(state, local, batch)

    return Step(run, _nbytes(local) + _nbytes(state) + _nbytes(batch),
                gathered, reduce_bytes)


def count_step(step: Step):
    """Run ``step`` once in analysis mode under a ``CostCount`` -> its
    ``Count`` (argument bytes filled in) and the seconds it took."""
    t0 = time.time()
    with analysis_mode(), CostCount() as cc:
        step.run()
    c = cc.count
    c.arg_bytes = step.arg_bytes
    c.buffer_bytes = step.buffer_bytes
    return c, time.time() - t0


def _meta_model(cfg):
    return build_model(cfg, kernels="cuda", device="meta")


def _pair(arch, shape_name, multi_pod, cache_shard, remat_policy, quiet):
    """(cfg, shape, mesh) of a pair to run, or None (SKIP printed) for a
    shape the arch does not take; ``A17bError`` for what A17b must add."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        if not quiet:
            print(f"SKIP {arch} × {shape_name}: {reason}")
        return None
    refuse_a17b(shape, cache_shard, remat_policy)
    return cfg, shape, make_production_mesh(multi_pod=multi_pod)


def _analyze(c, arch, shape_name, cfg, shape, mesh):
    chips = mesh.size()
    return roofline.analyze(
        c, arch=arch, shape=shape_name, mesh_name=_mesh_name(mesh),
        chips=chips,
        model_flops_per_device=roofline.model_flops(cfg, shape, chips))


def _record(out_dir, rl, tag, c, **extra):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    rec = dataclasses.asdict(rl)
    rec.update(extra, launches=dict(c.launches),
               flops_by_dtype=dict(c.flops_by_dtype),
               elementwise_gflops=c.elementwise_flops / 1e9)
    fname = f"{rl.arch}_{rl.shape}_{rl.mesh}{tag}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)


def dryrun_one(arch: str, shape_name: str, *, multi_pod=False, fsdp=True,
               inconsistent=True, out_dir="experiments/dryrun", quiet=False,
               isgd_stop=5, tag="", cache_shard="feature", micro=1,
               remat_policy="full"):
    pair = _pair(arch, shape_name, multi_pod, cache_shard, remat_policy,
                 quiet)
    if pair is None:
        return None
    cfg, shape, mesh = pair
    t0 = time.time()
    step = build_step(_meta_model(cfg), mesh, shape, fsdp=fsdp,
                      inconsistent=inconsistent, isgd_stop=isgd_stop,
                      cache_shard=cache_shard, micro=micro)
    t_build = time.time() - t0
    c, t_count = count_step(step)
    rl = _analyze(c, arch, shape_name, cfg, shape, mesh)
    hbm = roofline.H100_SXM["hbm_bytes"] / 1e9
    fits = rl.memory_per_device_gb <= hbm
    if not quiet:
        print(f"PASS {arch} × {shape_name} × {rl.mesh}  "
              f"build={t_build:.1f}s count={t_count:.1f}s  "
              f"fits={str(fits).lower()} ({rl.memory_per_device_gb:.1f} GB "
              f"{'<=' if fits else '>'} {hbm:.0f} GB)")
        print(f"  mem/device: args={c.arg_bytes/1e9:.2f}GB "
              f"buffers={c.buffer_bytes/1e9:.2f}GB (gathered params "
              f"{step.gathered_bytes/1e9:.2f}, reduction "
              f"{step.reduce_bytes/1e9:.2f}) "
              f"temp={c.temp_peak/1e9:.2f}GB out={c.out_bytes/1e9:.2f}GB")
        print(f"  per-device: {rl.hlo_gflops:.1f} GFLOP, {rl.hlo_gbytes:.1f} GB "
              f"HBM, {rl.collective_gbytes:.3f} GB collective; "
              f"launches {dict(sorted(c.launches.items()))}")
        print(f"  roofline: compute={rl.compute_s*1e3:.2f}ms "
              f"memory={rl.memory_s*1e3:.2f}ms "
              f"collective={rl.collective_s*1e3:.2f}ms -> {rl.bottleneck}-bound; "
              f"useful-flops={rl.useful_flops_ratio:.2f}")
    _record(out_dir, rl, tag, c, build_s=t_build, count_s=t_count,
            fsdp=fsdp, inconsistent=inconsistent, isgd_stop=isgd_stop,
            micro=micro, cache_shard=cache_shard, fits=fits, hbm_gb=hbm,
            arg_gb=c.arg_bytes / 1e9, buffer_gb=c.buffer_bytes / 1e9,
            gathered_gb=step.gathered_bytes / 1e9,
            reduce_gb=step.reduce_bytes / 1e9,
            temp_gb=c.temp_peak / 1e9, out_gb=c.out_bytes / 1e9)
    return rl


def _cfg_with_blocks(cfg, k: int):
    """Config truncated to k layer-blocks (same pattern) for extrapolation."""
    from repro_torch.models.transformer import stack_plan
    prefix, block, n_blocks = stack_plan(cfg)
    repl = {"num_layers": cfg.first_dense + k * len(block)}
    if cfg.family == "encdec":
        # encoder layers scale with the same k (whisper: 1 enc layer per block)
        repl["encoder_layers"] = max(1, k * cfg.encoder_layers // n_blocks)
    return dataclasses.replace(cfg, **repl), n_blocks


def extrapolate(c1: Count, c2: Count, n_blocks: int) -> Count:
    """The two-point extrapolation of two ``Count``s (k = 1, 2 blocks) to
    ``n_blocks``: x1 + (n_blocks − 1)·(x2 − x1) for each FLOP, byte and
    launch count, and for the count and bytes of each (kind, group) of
    collectives (the reference takes k = 2's count of a kind; this is
    the full depth's). Memory is not extrapolated: it stays 0, as in the
    reference's analysis records."""
    def lin(a, b):
        return a + (n_blocks - 1) * (b - a)

    def lin_map(a, b):
        return {k: lin(a.get(k, 0), b.get(k, 0)) for k in {*a, *b}}

    def by_kind_group(c):
        out = {}
        for r in c.collectives:
            n, b = out.get((r.kind, r.ranks), (0, 0))
            out[(r.kind, r.ranks)] = (n + r.n, b + r.bytes)
        return out

    g1, g2 = by_kind_group(c1), by_kind_group(c2)
    colls = []
    for key in sorted({*g1, *g2}):
        (n1, b1), (n2, b2) = g1.get(key, (0, 0)), g2.get(key, (0, 0))
        colls.append(Collective(key[0], lin(b1, b2), key[1], lin(n1, n2)))
    return Count(
        aten_flops=lin(c1.aten_flops, c2.aten_flops),
        aten_bytes=lin(c1.aten_bytes, c2.aten_bytes),
        kernel_flops=lin(c1.kernel_flops, c2.kernel_flops),
        kernel_bytes=lin(c1.kernel_bytes, c2.kernel_bytes),
        elementwise_flops=lin(c1.elementwise_flops, c2.elementwise_flops),
        flops_by_dtype=lin_map(c1.flops_by_dtype, c2.flops_by_dtype),
        launches=lin_map(c1.launches, c2.launches),
        kernels={k: lin_map(c1.kernels.get(k, {}), c2.kernels.get(k, {}))
                 for k in {*c1.kernels, *c2.kernels}},
        collectives=colls)


def analysis_one(arch: str, shape_name: str, *, multi_pod=False, fsdp=True,
                 inconsistent=True, isgd_stop=5, out_dir="experiments/roofline",
                 quiet=False, tag="", cache_shard="feature", micro=1,
                 remat_policy="full"):
    """Roofline terms by two-point extrapolation over n_blocks
    (``analysis.mode``). Records a Roofline JSON per pair."""
    pair = _pair(arch, shape_name, multi_pod, cache_shard, remat_policy,
                 quiet)
    if pair is None:
        return None
    cfg, shape, mesh = pair
    t0 = time.time()
    raw = {}
    for k in (1, 2):
        cfg_k, n_blocks = _cfg_with_blocks(cfg, k)
        step = build_step(_meta_model(cfg_k), mesh, shape, fsdp=fsdp,
                          inconsistent=inconsistent, isgd_stop=isgd_stop,
                          cache_shard=cache_shard, micro=micro)
        raw[k], _ = count_step(step)
    c = extrapolate(raw[1], raw[2], n_blocks)
    rl = _analyze(c, arch, shape_name, cfg, shape, mesh)
    wall = time.time() - t0
    if not quiet:
        print(f"ROOFLINE {arch} × {shape_name} × {rl.mesh}: "
              f"compute={rl.compute_s*1e3:.2f}ms memory={rl.memory_s*1e3:.2f}ms "
              f"collective={rl.collective_s*1e3:.2f}ms -> {rl.bottleneck}-bound "
              f"useful={rl.useful_flops_ratio:.2f}")
        print(f"PASS {arch} × {shape_name} × {rl.mesh}  count={wall:.1f}s")
    _record(out_dir, rl, tag, c, fsdp=fsdp, inconsistent=inconsistent,
            isgd_stop=isgd_stop, cache_shard=cache_shard, micro=micro,
            remat_policy=remat_policy, count_s=wall)
    return rl


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry-run and roofline of the training step at the "
                    "production mesh, on the meta device (module doc).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--consistent", dest="inconsistent", action="store_false",
                    help="count the baseline (non-ISGD) train step")
    ap.add_argument("--isgd-stop", type=int, default=5)
    ap.add_argument("--cache-shard", default="feature",
                    choices=["feature", "batch"],
                    help="decode cache layout (batch: slice A17b)")
    ap.add_argument("--micro", type=int, default=1,
                    help="gradient-accumulation micro-batches")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "tp_out"],
                    help="activation-checkpoint policy (tp_out: slice A17b)")
    ap.add_argument("--tag", default="", help="suffix for the output json")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mode", default="dryrun", choices=["dryrun", "analysis"],
                    help="dryrun = the full-depth step; analysis = two-point "
                         "extrapolation over the layer blocks")
    args = ap.parse_args(argv)
    refuse_a17b(None, args.cache_shard, args.remat_policy)
    if args.shape is not None:
        refuse_a17b(INPUT_SHAPES[args.shape])
    out_dir = args.out or ("experiments/dryrun" if args.mode == "dryrun"
                           else "experiments/roofline")

    archs = [args.arch] if args.arch and not args.all else ARCH_IDS
    shapes = [args.shape] if args.shape and not args.all else list(INPUT_SHAPES)
    pairs = [(a, s) for a in archs for s in shapes]

    run = dryrun_one if args.mode == "dryrun" else analysis_one
    failures, skipped = [], 0
    t0 = time.time()
    for arch, shape in pairs:
        if INPUT_SHAPES[shape].kind != "train":
            print(f"SKIP {arch} × {shape}: not ported (A17b)")
            skipped += 1
            continue
        try:
            run(arch, shape, multi_pod=args.multi_pod, fsdp=args.fsdp,
                inconsistent=args.inconsistent, out_dir=out_dir,
                isgd_stop=args.isgd_stop, tag=args.tag, micro=args.micro)
        except Exception as e:  # noqa: BLE001 — report all failures at end
            failures.append((arch, shape, repr(e)[:200]))
            print(f"FAIL {arch} × {shape}: {e!r}"[:400])
    wall = time.time() - t0
    if failures:
        print(f"\n{len(failures)} FAILURES ({skipped} skipped, A17b) "
              f"in {wall:.1f}s")
        raise SystemExit(1)
    print(f"\nALL DRY-RUNS PASSED ({len(pairs) - skipped} run, {skipped} "
          f"skipped, A17b) in {wall:.1f}s")
    return 0


if __name__ == "__main__":
    main()
