"""Training launcher: the single-device ISGD engines, per-step and fused.

Port of the single-device engines of ``repro.launch.train``. It trains
one of the ``paper_transformer`` zoo models (``--model transformer|moe|ssm
--tier tiny|base``) or one of the ten assigned architectures (``--arch
ID``, with ``--reduced`` its CPU-size variant); exactly one of ``--model``
and ``--arch`` is given. It builds the model, draws the synthetic LM token
stream (``make_lm_tokens(0, n_seqs, seq, vocab)``) into an FCPR ring
(``seed=1``), and trains through the per-step engine
(``make_train_step``, its metrics deferred to the print boundaries as
``repro_torch.train.train`` defers them), printing the JAX launcher's
``step N loss= psi_bar= limit= accel=`` lines and its
``done: ... accelerated= sub_iters=`` line. A VLM or an enc-dec model gets
constant zero frontend embeddings in bf16 (``frontend_embeds``), in every
batch, as the JAX launcher feeds them.

``--chunk-steps K`` (K > 1) runs the fused engine
(``repro_torch.train.make_chunked_train_step``): the epoch lives on the
device (``DeviceRing``), K steps run per host dispatch (on the card, K
replays of a CUDA graph of one step, the accelerate branch and Alg. 2 in
IF nodes), the step count rounds up to whole chunks and the last step of
each chunk is printed. The warm-up and capture happen before the clock
(``capture:`` line). ``--device-ring`` feeds the per-step engine from the
device-resident ring (``ring_or_prefetch``: the ring if the epoch fits
256 MiB, else a double-buffered prefetcher).

``--schedule SPEC`` (``fcpr | loss-prop | rank``, options as
``family:k=v,...``; ``repro_torch.sched``) selects each step's batch on the
device from the ring instead of the FCPR walk: per-step
(``make_scheduled_train_step``, ``batch=`` in the step lines) or fused
(``--chunk-steps K``: the draw, the table update and the gather inside the
graph; ``visits=`` a chunk). ``--checkpoint-dir D --checkpoint-every N``
writes crash-consistent engine checkpoints (``train.checkpoints``: params,
ISGD state, policy table, step; the JAX package's format) at the first
step or chunk boundary past each multiple of N; ``--resume`` restores the
newest one in place and continues from its step, on the uninterrupted
run's trajectory bit for bit (a resumed fused run may start mid-chunk).
``--publish-dir D --publish-every N`` publishes an engine checkpoint every
N steps into D with the atomic ``LATEST`` pointer that a serving process
polls (``python -m repro_torch.launch.serve --watch --publish-dir D``).

``--engine data-parallel`` (alias ``--data-parallel``) trains through the
data-parallel engine (``repro_torch.distributed``) on the 1-D ``(data,)``
mesh: params replicated (rank 0's, broadcast), each rank on its rows of
every batch, ψ and the gradients gathered and averaged in rank order every
evaluation. ``--engine hybrid`` (alias ``pjit``) trains on the ``(data,
model)`` mesh of ``--model-parallel M`` (``(pod, data, model)`` across
nodes), following the reference's ``run_sync``: with M = 1 it is the same
data-parallel engine; with M > 1 the params are placed by
``launch.shardings.hybrid_params_placement`` (attention by heads, the
MLP by ``d_ff`` and an MoE layer by its experts or within each expert
over ``model``, FSDP over ``data``), the activation rule
table is installed (``sharding.rules``), each step takes the global batch
(the ring in global row order) and each rank trains on its data rows with
its model slices. Without process arguments it is one rank (a one-rank
group: NCCL on the card, gloo on the CPU); ``--coordinator host:port
--num-processes N --process-id r`` (or ``torchrun``'s environment) makes N
ranks, and ``--dist-backend gloo`` lets them share one card.
``--chunk-steps``, ``--device-ring``, ``--schedule``, ``--checkpoint-*``
(rank 0 writes, the others validate their replicas; with M > 1 the
checkpoint holds the whole tensors, gathered, and a resume takes each
rank's part back) and ``--obs-dir`` compose with both. A ``--batch`` the
data ranks do not divide exits 1, as does an M that does not divide the
ranks (the mesh's ``MeshError``) or ``--model-parallel > 1`` with
``--engine data-parallel``. Only rank 0 prints. Without ``--engine`` the
run is the single-device engines' as above.

``--engine async-ps`` trains through the asynchronous parameter server
(``repro_torch.distributed.async_ps``, paper §6.2): ``--workers N`` threads
of this process, each with a replica of the model, pull the server's
canonical params, train on their FCPR stripe (worker w's step k is global
batch ``k·N + w``) and push; the server runs the SPC chart over every
worker's ψ and folds a push that raced τ others with ``w(τ)``
(``--staleness-decay``). ``--max-staleness s`` is the SSP bound (0:
lockstep rounds; one worker at 0 is the per-step engine bit for bit).
``--elastic`` evicts a crashed worker or one that misses the heartbeat
``--deadline`` and re-stripes its shard; ``--fault-plan SPEC``
(``repro_torch.fault``) injects crashes, hangs, slow steps, corrupt and
transient pushes; ``--verify-pushes`` checksums every push. It warms up
(kernels, the subproblem, the server's folds) before the clock. It prints
the reference's ``push N wW tau=T ...`` lines (the first and every 5th),
an ``event: ...`` line per eviction or crash and a ``staleness:
mean_tau=... max_tau=... bound=...`` line. ``--checkpoint-every N``
counts applied pushes (written under the server lock) and ``--resume``
restores the server's version and push clocks. It refuses
``--chunk-steps > 1``, ``--device-ring``, ``--schedule``, a VLM or an
enc-dec config, ``--model-parallel > 1`` and more than one process.

``--obs-dir D`` writes the run's telemetry (``repro_torch.obs``) to
``D/metrics.p0.jsonl`` and ``D/summary.json``: the SPC control chart, step
and dispatch counters and the ``spc.final`` snapshot, reconciled bit for bit
with the engine's queue (the ``obs: D spc_reconciled=... accel_events=...``
line before ``done:``). It takes the metrics at the fetches the engines
already make. ``--profile-dir D`` writes a ``torch.profiler`` trace of the
timed steps into D.

The run is on the card unless ``--device cpu`` is given; without a CUDA
device and without that flag it exits nonzero. With ``--kernels cuda`` on
the card the kernels are built before the clock starts.

  PYTHONPATH=src python -m repro_torch.launch.train --model transformer \\
      --tier base --kernels cuda --precision bf16 --batch 8 --seq 1024 \\
      --n-seqs 32 --steps 12 --k-sigma 1.0 --stop 3
  PYTHONPATH=src python -m repro_torch.launch.train --model ssm --tier base \\
      --kernels cuda --precision bf16 --batch 8 --seq 1024 --n-seqs 32 \\
      --steps 12 --k-sigma 1.0 --stop 3
  PYTHONPATH=src python -m repro_torch.launch.train --model moe --tier base \\
      --kernels cuda --precision bf16 --batch 8 --seq 1024 --n-seqs 32 \\
      --steps 12 --k-sigma 1.0 --stop 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba_v0_1_52b \\
      --reduced --batch 2 --seq 64 --n-seqs 8 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model transformer --tier tiny --steps 6 --seq 64 --n-seqs 32 \\
      [--chunk-steps 4] [--obs-dir /tmp/obs] [--profile-dir /tmp/prof] \\
      [--schedule loss-prop] [--checkpoint-dir /tmp/ck --checkpoint-every 4 \\
      [--resume]]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model transformer --tier tiny --steps 6 --seq 64 --n-seqs 32 \\
      --engine data-parallel --coordinator 127.0.0.1:29511 \\
      --num-processes 2 --process-id 0      # and --process-id 1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model transformer --tier tiny --steps 6 --seq 64 --n-seqs 32 \\
      --engine hybrid --model-parallel 2 --coordinator 127.0.0.1:29512 \\
      --num-processes 2 --process-id 0      # and --process-id 1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model transformer --tier tiny --steps 8 --seq 64 --n-seqs 32 \\
      --engine async-ps --workers 2 --max-staleness 1
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch.configs import ZOO_MODELS, ZOO_TIERS, get_config, zoo_config
from repro_torch.core import ISGDConfig, constant_lr
from repro_torch.data import (DeviceRing, FCPRSampler, make_lm_tokens,
                              ring_or_prefetch)
from repro_torch.device import resolve_device
from repro_torch.distributed.data_parallel import (data_axis_size,
                                                   make_chunked_hybrid_step,
                                                   make_hybrid_step,
                                                   replicate_to_mesh,
                                                   tensor_axes)
from repro_torch.distributed.prefetch import prefetched
from repro_torch.kernels import KERNEL_CHOICES, build
from repro_torch.launch import env as ENV
from repro_torch.launch.env import p0print
from repro_torch.launch.mesh import (MeshError, make_data_mesh,
                                     make_training_mesh)
from repro_torch.launch.shardings import hybrid_params_placement
from repro_torch.models import build_model
from repro_torch.models.api import frontend_embeds as api_frontend_embeds
from repro_torch.obs import (ConsoleSink, JsonlSink, MetricsRecorder,
                             TrainObserver, jsonl_path, maybe_profile,
                             write_merged_summary)
from repro_torch.obs.console import is_coordinator, process_index
from repro_torch.optim import RULES
from repro_torch.sched.policies import schedule_from_spec
from repro_torch.sharding import activation_sharding, rules
from repro_torch.train import (TrainLog, host_metrics,
                               make_chunked_train_step,
                               make_scheduled_train_step, make_train_step)
from repro_torch.train.checkpoints import (Checkpointer, layout_for,
                                           restore_engine)
from repro_torch.train.trainer import Deferred


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="assigned architecture config (repro_torch.configs)")
    ap.add_argument("--model", default=None, choices=list(ZOO_MODELS),
                    help="paper_transformer zoo family (alternative to "
                         "--arch)")
    ap.add_argument("--tier", default="tiny", choices=list(ZOO_TIERS),
                    help="zoo tier for --model (tiny = CPU tests, base = "
                         "the card)")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-size variant of an --arch config")
    ap.add_argument("--kernels", default="cuda", choices=list(KERNEL_CHOICES),
                    help="cuda: the hand-written kernels (their plain "
                         "versions on a CPU device); reference: the model's "
                         "own plain paths")
    ap.add_argument("--precision", default="bf16", choices=["bf16", "f32"],
                    help="compute dtype for params/activations (psi "
                         "statistics and the SPC queue stay f32)")
    ap.add_argument("--remat", default="full", choices=["full", "none"],
                    help="recompute each layer in the backward pass")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--rule", default="momentum", choices=list(RULES))
    ap.add_argument("--consistent", action="store_true")
    ap.add_argument("--k-sigma", type=float, default=2.0)
    ap.add_argument("--stop", type=int, default=3)
    ap.add_argument("--n-seqs", type=int, default=64)
    ap.add_argument("--chunk-steps", type=int, default=1,
                    help="K>1 = fused engine: K ISGD steps per host dispatch "
                         "over the device-resident FCPR ring (a CUDA graph of "
                         "one step on the card; bit-exact with per-step)")
    ap.add_argument("--device-ring", action="store_true",
                    help="per-step engine fed from the device-resident FCPR "
                         "ring instead of host batches (implied by "
                         "--chunk-steps > 1)")
    ap.add_argument("--schedule", default=None,
                    help="batch-selection policy (repro_torch.sched): "
                         "fcpr | loss-prop | rank, with options as "
                         "family:k=v,... (e.g. loss-prop:eps=0.2).  "
                         "Selection runs on device over the ring; fcpr is "
                         "bit-exact with the default engines; omit for the "
                         "hard-wired FCPR paths")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for crash-consistent full-engine "
                         "checkpoints (atomic .npz, checksummed; "
                         "repro_torch.train.checkpoints)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint cadence in steps (saved at the first "
                         "step/chunk boundary past each mark; async-ps: "
                         "every N applied pushes, written under the server "
                         "lock).  0 = never")
    ap.add_argument("--publish-dir", default=None,
                    help="train-and-serve: directory where full-engine "
                         "checkpoints are published for a live serving "
                         "process (atomic LATEST pointer; a "
                         "repro_torch.serve.SnapshotWatcher hot-swaps each "
                         "one between decode steps).  May equal "
                         "--checkpoint-dir")
    ap.add_argument("--publish-every", type=int, default=0,
                    help="publish cadence in steps (0 = inherit "
                         "--checkpoint-every)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest complete checkpoint in "
                         "--checkpoint-dir (a resumed run continues the "
                         "uninterrupted trajectory bit-exactly — "
                         "repro_torch.train.resume_parity)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when named")
    ap.add_argument("--obs-dir", default=None,
                    help="telemetry directory (repro_torch.obs): "
                         "metrics.pN.jsonl with the live SPC control chart, "
                         "counters and events, and a summary.json; taken at "
                         "the engines' existing host fetches")
    ap.add_argument("--obs-console-every", type=int, default=0,
                    help="print a one-line obs counter summary every N "
                         "steps (0 = off; needs --obs-dir)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the timed steps "
                         "into this directory (spans obs/chunk_scan, "
                         "obs/psi_push, obs/accelerate)")
    ap.add_argument("--engine", default=None,
                    choices=["hybrid", "pjit", "data-parallel", "async-ps"],
                    help="data-parallel: the data-parallel engine on the "
                         "(data,) mesh; hybrid/pjit: the DP x TP engine on "
                         "the (data, model) mesh of --model-parallel; "
                         "async-ps: the asynchronous parameter server "
                         "(worker threads); omit for the single-device "
                         "engines")
    ap.add_argument("--data-parallel", action="store_true",
                    help="alias for --engine data-parallel")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="hybrid engine: ranks on the tensor-parallel "
                         "'model' axis (must divide the ranks; the rest "
                         "form the data axes)")
    ap.add_argument("--workers", type=int, default=2,
                    help="async-ps: number of worker threads")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="async-ps: SSP bound — a worker may start step k "
                         "only when every worker finished step k-N; 0 = "
                         "lockstep (synchronous schedule)")
    ap.add_argument("--staleness-decay", default="inverse",
                    help="async-ps: w(tau) family[:alpha] — inverse "
                         "(1/(1+a*tau)), exp (e^-a*tau), none")
    ap.add_argument("--elastic", action="store_true",
                    help="async-ps: evict crashed/deadline-missing workers "
                         "and re-stripe their FCPR shard across survivors "
                         "instead of failing the run")
    ap.add_argument("--deadline", type=float, default=120.0,
                    help="async-ps: heartbeat deadline in seconds — a "
                         "worker blocking the SSP clock without a "
                         "heartbeat for this long is stalled (evicted when "
                         "--elastic, fatal diagnostic otherwise)")
    ap.add_argument("--fault-plan", default=None,
                    help="async-ps: deterministic fault injection spec, "
                         "kind@worker:step[:key=value,...] joined by ';' — "
                         "e.g. 'crash@2:5;hang@1:8:seconds=1.0' "
                         "(repro_torch.fault)")
    ap.add_argument("--verify-pushes", action="store_true",
                    help="async-ps: workers checksum their deltas and the "
                         "server rejects corrupt arrivals (rejected/"
                         "transient pushes retry with backoff)")
    ENV.add_process_args(ap)
    return ap.parse_args(argv)


def engine_of(args):
    """The engine's name: ``data-parallel``, ``hybrid``, ``async-ps``, or
    None for the single-device engines; raises ValueError for a
    combination no engine runs. ``--coordinator`` or ``--num-processes``
    alone implies the data-parallel engine."""
    engine = args.engine or ("data-parallel" if args.data_parallel else None)
    if engine is None and (args.coordinator
                           or args.num_processes not in (None, 1)):
        engine = "data-parallel"
    if engine == "async-ps":
        if args.model_parallel != 1:
            raise ValueError("--model-parallel composes with --engine "
                             "hybrid, not --engine async-ps")
        if args.coordinator or args.num_processes not in (None, 1):
            raise ValueError("--engine async-ps runs its workers as threads "
                             "of one process; drop --coordinator and "
                             "--num-processes")
        return engine
    if engine is None:
        if args.model_parallel != 1:
            raise ValueError("--model-parallel needs --engine hybrid")
        return None
    if engine == "data-parallel" and args.model_parallel != 1:
        raise ValueError("--model-parallel composes with --engine hybrid, "
                         "not --engine data-parallel")
    return "data-parallel" if engine == "data-parallel" else "hybrid"


def data_mesh(args, dev):
    """The engine's mesh over the process group: 1-D ``(data,)`` for
    ``data-parallel``, ``make_training_mesh(model=M)`` for ``hybrid``;
    exits 1 when the mesh cannot be built or the data ranks do not divide
    ``--batch``."""
    try:
        if engine_of(args) == "data-parallel":
            mesh = make_data_mesh(dev.type, args.dist_backend)
        else:
            mesh = make_training_mesh(args.model_parallel, device=dev.type,
                                      backend=args.dist_backend)
    except MeshError as e:
        raise SystemExit(f"error: {e}") from None
    n = data_axis_size(mesh)
    if args.batch % n:
        raise SystemExit(f"--batch {args.batch} must be a multiple of the "
                         f"{n} data-parallel ranks (it is split across "
                         f"them)")
    return mesh


def refuse_async(args, cfg) -> None:
    """Raise ValueError for what the async-PS engine does not run, as the
    reference's ``run_async_ps`` refuses it."""
    if cfg.family in ("vlm", "encdec"):
        raise ValueError("--engine async-ps supports decoder-only/cnn "
                         "configs (no constant frontend-embed plumbing)")
    if args.chunk_steps > 1 or args.device_ring:
        raise ValueError("--chunk-steps/--device-ring do not compose with "
                         "--engine async-ps (workers dispatch per step from "
                         "host snapshots, there is no fused scan or device "
                         "ring in this engine)")
    if args.schedule is not None:
        raise ValueError("--schedule does not compose with --engine "
                         "async-ps (workers own fixed FCPR stripes; a "
                         "shared selection policy would race the table)")
    if args.workers < 1 or args.max_staleness < 0:
        raise ValueError("--workers must be >= 1 and --max-staleness >= 0")


def resolve_config(args):
    """The config that ``--model``/``--tier`` or ``--arch``/``--reduced``
    name; raises ValueError unless exactly one of ``--model`` and
    ``--arch`` is given, or on ``--reduced`` with ``--model``."""
    if (args.arch is None) == (args.model is None):
        raise ValueError("pass exactly one of --arch or --model")
    if args.model is not None:
        if args.reduced:
            raise ValueError("--reduced applies to --arch configs; the zoo's "
                             "CPU tier is --tier tiny")
        return zoo_config(args.model, args.tier)
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def frontend_embeds(cfg, batch_size: int, device) -> dict:
    """Constant zero frontend embeddings in bf16 for a VLM (image tokens)
    or an enc-dec model (audio frames), as the JAX launcher makes them
    (``models.api.frontend_embeds``), as a batch entry; {} for the other
    families."""
    fe = api_frontend_embeds(cfg, batch_size, device)
    return {} if fe is None else {"frontend_embeds": fe}


def ring_epoch(cfg, sampler, batch_size: int, device) -> dict:
    """Epoch arrays for a ``DeviceRing``, with the frontend embeddings
    tiled to one row per sample, so that a ring slice is the batch the
    per-step engine gets."""
    epoch = dict(sampler.epoch_arrays())
    for k, v in frontend_embeds(cfg, batch_size, device).items():
        epoch[k] = v.repeat(sampler.n_batches, *(1,) * (v.dim() - 1))
    return epoch


class WithExtras:
    """A sampler whose batches also carry the tensors of ``extra``."""

    def __init__(self, sampler, extra: dict):
        self.sampler, self.extra = sampler, extra
        self.n_batches = sampler.n_batches

    def __call__(self, j: int) -> dict:
        return dict(self.sampler(j), **self.extra)


class _TeeCheckpointer:
    """Fan a run's saves out to several ``Checkpointer``s: the
    crash-recovery directory and the serving publish directory can differ
    (cadence, pruning) without threading two objects through the step
    loops. ``latest``, ``layout`` and ``recorder`` are the first's."""

    def __init__(self, ckpts):
        self.ckpts = ckpts
        self.directory = ckpts[0].directory
        self.layout = ckpts[0].layout
        self.recorder = ckpts[0].recorder

    def maybe_save(self, step, **kw):
        outs = [c.maybe_save(step, **kw) for c in self.ckpts]
        return next((o for o in outs if o), None)

    def mark(self, step):
        for c in self.ckpts:
            c.mark(step)

    def latest(self):
        return self.ckpts[0].latest()


def _make_checkpointer(args, layout, recorder=None):
    """``--checkpoint-dir``/``--checkpoint-every`` -> a ``Checkpointer``
    naming the params by ``layout``; ``--publish-dir`` adds (or, when it is
    the same directory, upgrades to) a publishing one that keeps the atomic
    ``LATEST`` pointer a serving ``SnapshotWatcher`` polls. None when both
    are off."""
    publish = args.publish_dir
    same = bool(publish and args.checkpoint_dir and os.path.abspath(publish)
                == os.path.abspath(args.checkpoint_dir))
    ckpts = []
    if args.checkpoint_dir:
        ckpts.append(Checkpointer(args.checkpoint_dir,
                                  every=args.checkpoint_every, pointer=same,
                                  layout=layout, recorder=recorder))
    if publish and not same:
        every = args.publish_every or args.checkpoint_every
        if not every:
            raise SystemExit("--publish-dir needs --publish-every (or "
                             "--checkpoint-every) to set the snapshot "
                             "cadence")
        ckpts.append(Checkpointer(publish, every=every, pointer=True,
                                  layout=layout, recorder=recorder))
    if not ckpts:
        return None
    return ckpts[0] if len(ckpts) == 1 else _TeeCheckpointer(ckpts)


def _maybe_resume(args, ckpt, *, params_like, state_like, sched_like=None,
                  placement=None):
    """``--resume``: restore the newest complete checkpoint in the directory
    (atomic saves guarantee completeness) into the run's freshly built
    params, state and policy state, in place (with a tensor-parallel
    ``placement``: into whole-tensor copies, then each rank's part back
    into its shards). Returns the ``EngineCheckpoint`` (its ``state``
    carries a per-step state's counters) or None."""
    if not (args.resume and ckpt is not None):
        return None
    latest = ckpt.latest()
    if latest is None:
        p0print(f"resume: no checkpoint under {ckpt.directory!r}; "
                f"starting fresh")
        return None
    local_state = state_like
    if placement is not None:
        params_like = placement.full(params_like)
        state_like = state_like._replace(
            base=placement.full_tree(state_like.base))
    ck = restore_engine(latest, params_like=params_like,
                        state_like=state_like, sched_like=sched_like,
                        layout=ckpt.layout, recorder=ckpt.recorder)
    if placement is not None:
        placement.load_full(ck.params)
        placement.load_full_tree(ck.state.base, local_state.base)
        ck = ck._replace(params=placement.local,
                         state=ck.state._replace(base=local_state.base))
    ckpt.mark(ck.step)
    p0print(f"resume: restored {latest!r} at step {ck.step}")
    return ck


def _make_observer(args, cfg, icfg, engine: str, table: bool = False,
                   replay_exact: bool = True):
    """``--obs-dir`` -> a ``TrainObserver`` writing this process's JSONL
    (tagged process_id/engine/model), or None when obs is off. The SPC
    exporter replays the engine's queue discipline: per-batch table writes
    (``table``) for ``uses_table`` schedules, FIFO otherwise. Multi-worker
    async-PS runs push in commit order but observe losses in a (possibly
    different) race order, so their replay is chart-only — counters still
    reconcile exactly (``replay_exact=False``)."""
    if not args.obs_dir:
        return None
    os.makedirs(args.obs_dir, exist_ok=True)
    pid = process_index()
    sinks = [JsonlSink(jsonl_path(args.obs_dir, pid))]
    if args.obs_console_every:
        sinks.append(ConsoleSink(every=args.obs_console_every))
    rec = MetricsRecorder(sinks, tags={"process_id": pid, "engine": engine,
                                       "model": cfg.name})
    return TrainObserver(rec, n_batches=icfg.n_batches, k_sigma=icfg.k_sigma,
                         table=table, examples_per_step=args.batch,
                         replay_exact=replay_exact)


def run(args, *, fused=None, profiler=None, on_step=None,
        snapshot_hook=None) -> dict:
    """Train as ``args`` say (``_run``); a data-parallel run makes its
    process group first (``--coordinator`` …, else a one-rank group that
    lasts for the run). ``snapshot_hook`` goes to the async-PS workers
    (``async_ps.worker.Worker``)."""
    if engine_of(args) in (None, "async-ps"):
        return _run(args, None, fused=fused, profiler=profiler,
                    on_step=on_step, snapshot_hook=snapshot_hook)
    dev = resolve_device(args.device)
    ENV.initialize_from_args(args, dev)
    with ENV.local_group(dev, args.dist_backend):
        return _run(args, data_mesh(args, dev), fused=fused,
                    profiler=profiler, on_step=on_step)


def _run(args, mesh, *, fused=None, profiler=None, on_step=None,
         snapshot_hook=None) -> dict:
    """Train as ``args`` say. ``fused`` (default ``--chunk-steps > 1``)
    picks the chunked engine, so that K = 1 can run through it too;
    ``profiler`` (a ``torch.profiler.profile``; ``--profile-dir`` makes
    one with ``obs.maybe_profile``) is entered around the timed steps only,
    and stepped after each chunk of the chunked engine.
    -> {"log", "batch_idx", "state", "sched_state", "model", "seconds",
    "steps",
    "start", "peak_bytes", "peak_reserved", "params", "capture_seconds",
    "chunk_steps", "obs", "ranks", "reduce_bytes"} (``model``: the
    trained ``Model``; ``params``: its parameter count; ``steps``: the
    last step run, ``start`` the first (the resumed step, else 0), and the
    log holds the steps between; ``obs``: the ``spc.final`` payload with
    ``--obs-dir``, else None; ``batch_idx``: a scheduled run's batch
    picks, one a step of the log; ``ranks``: the data-parallel ranks, 0
    for the single-device engines; ``reduce_bytes``: the bytes of the
    data-parallel reduction's buffers on this rank, its ``AxisReduce``'s
    ``buffer_bytes``, else None; ``placement``: the tensor-parallel
    ``launch.shardings.Placement``, else None; ``local_params``: the
    params the engine updated, this rank's shards where placed;
    ``tp_bytes``: with a placement, the bytes this rank received in
    model-axis sums over the run (``TensorParallel.moved``) and in
    parameter gathers an evaluation, else None).
    ``on_step(j, carry)``, if given, runs after each per-step step (j the
    steps done). An async-PS run goes to ``_run_async``."""
    dev = resolve_device(args.device)
    engine = engine_of(args)
    k = args.chunk_steps
    if fused is None:
        fused = k > 1
    if args.profile_dir:
        if profiler is not None:
            raise ValueError("pass --profile-dir or a profiler, not both")
        profiler = maybe_profile(args.profile_dir)
    cfg = resolve_config(args)
    dtype = torch.float32 if args.precision == "f32" else torch.bfloat16
    model = build_model(cfg, kernels=args.kernels, param_dtype=dtype,
                        remat=args.remat != "none", device=dev)
    model.init(0)
    layout = layout_for(model.module)
    if engine == "async-ps":
        return _run_async(args, dev, cfg, model, dtype, layout,
                          profiler=profiler, snapshot_hook=snapshot_hook)
    params = model.params()
    n_params = sum(p.numel() for p in params)
    ranks = 0 if mesh is None else mesh.size()
    n_data = 1 if mesh is None else data_axis_size(mesh)
    tp = mesh is not None and bool(tensor_axes(mesh))
    local_batch = args.batch // n_data
    kind = 'chunked' if fused else 'per-step'
    p0print(f"arch={cfg.name} engine="
            f"{kind if mesh is None else f'{engine} ({kind})'} "
            f"chunk_steps={k if fused else 1} device={dev} "
            f"kernels={args.kernels} precision={args.precision} "
            f"remat={args.remat}")
    placement, constrain, resolved = None, contextlib.nullcontext(), None
    if mesh is not None:
        replicate_to_mesh(params, mesh)
        shape = {a: n for a, n in zip(mesh.mesh_dim_names, mesh.shape)
                 if a == "data" or n > 1}
        p0print(f"mesh={shape} processes={ranks} "
                f"backend={ENV.topology().backend} "
                f"per_device_batch={local_batch}")
    if tp:
        # the tensor-parallel strategy: placed params and the activation
        # rule table, as the reference's run_sync installs them
        params, placement = hybrid_params_placement(mesh, model.module)
        table = rules.activation_rule_table(mesh, args.batch)
        resolved = rules.make_constrain(mesh, table)
        constrain = activation_sharding(resolved)
        held = sum(p.numel() for p in params)
        p0print(f"params: {n_params/1e6:.1f}M (model/FSDP-sharded, "
                f"{held/1e6:.1f}M a rank)")
    else:
        p0print(f"params: {n_params/1e6:.1f}M"
                + ("" if mesh is None else " (replicated)"))
    if args.kernels == "cuda" and dev.type == "cuda":
        build.build_all()

    data = make_lm_tokens(0, args.n_seqs, args.seq, cfg.vocab_size)
    sampler = FCPRSampler(data, batch_size=args.batch, seed=1)
    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=args.k_sigma,
                      stop=args.stop)
    rule, lr_fn = RULES[args.rule](), constant_lr(args.lr)
    schedule = None
    if args.schedule is not None:
        schedule = schedule_from_spec(args.schedule)
        p0print(f"schedule: {schedule} (device-resident selection; "
                f"non-FCPR policies read SPC limits from the per-batch loss "
                f"table)")
    obs = _make_observer(args, cfg, icfg, "chunked" if fused else "per-step",
                         table=schedule is not None and schedule.uses_table)
    ckpt = _make_checkpointer(args, layout,
                              recorder=obs.recorder if obs is not None
                              else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    capture = 0.0
    sched_state = None
    common = dict(inconsistent=not args.consistent, lr_fn=lr_fn)
    if fused or schedule is not None:
        # the fused engine and every scheduled engine select on the device:
        # the ring is mandatory
        ring = DeviceRing(ring_epoch(cfg, sampler, args.batch, dev),
                          args.batch, device=dev, mesh=mesh, axis=None,
                          relayout=not tp)
    if mesh is not None:
        if fused:
            init_fn, step_fn = make_chunked_hybrid_step(
                model.loss_fn, rule, icfg, mesh, chunk_steps=k,
                schedule=schedule, **common)
        else:
            init_fn, step_fn = make_hybrid_step(
                model.loss_fn, rule, icfg, mesh, schedule=schedule, **common)
    elif fused:
        init_fn, step_fn = make_chunked_train_step(
            model.loss_fn, rule, icfg, chunk_steps=k, schedule=schedule,
            **common)
    elif schedule is not None:
        init_fn, step_fn = make_scheduled_train_step(
            model.loss_fn, rule, icfg, schedule, **common)
    else:
        init_fn, step_fn = make_train_step(model.loss_fn, rule, icfg,
                                           **common)
    state = init_fn(params)
    if schedule is not None:
        sched_state = schedule.init(icfg.n_batches, device=dev)
    ck = _maybe_resume(args, ckpt, params_like=params, state_like=state,
                       sched_like=sched_state, placement=placement)
    if placement is not None and ckpt is not None:
        ckpt = _WholeTensors(ckpt, placement)
    start = 0
    if ck is not None:
        state, start = ck.state, ck.step
    carry = (state, params) + (() if schedule is None else (sched_state,))
    if fused:
        step_fn.prepare(*carry, ring.arrays)
        capture = step_fn.capture_seconds
        if dev.type == "cuda":
            p0print(f"capture: {capture:.1f}s (warm-up and graph capture)")
    elif schedule is not None:
        def one_step(carry, j):
            *carry, m = step_fn(*carry, ring.arrays, j)
            return tuple(carry), m
    else:
        feed = sampler
        if args.device_ring:
            feed = ring_or_prefetch(sampler, device=dev, mesh=mesh,
                                    axis=None, relayout=not tp)
            p0print(f"input: {type(feed).__name__}")
        elif mesh is not None and not tp:  # this rank's rows, staged ahead
            feed = prefetched(sampler, mesh, axis=None, device=dev)
        extra = frontend_embeds(cfg, args.batch if tp else local_batch, dev)
        if extra:
            feed = WithExtras(feed, extra)

        def one_step(carry, j):
            batch = {n: torch.as_tensor(v).to(dev) for n, v in feed(j).items()}
            *carry, m = step_fn(*carry, batch)
            return tuple(carry), m
    with profiler if profiler is not None else contextlib.nullcontext(), \
            constrain:
        t0 = time.perf_counter()
        if fused:
            carry, steps, log, picks = _drive_chunks(
                step_fn, carry, ring, args.steps, k, t0, start=start,
                ckpt=ckpt, on_chunk=getattr(profiler, "step", None), obs=obs)
        else:
            carry, steps, log, picks = _drive_steps(
                one_step, carry, args.steps, t0, start=start, ckpt=ckpt,
                obs=obs, on_step=on_step)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    state = carry[0]
    ran = max(steps - start, 1)
    final = None
    if obs is not None:
        # a resumed run missed the pushes before the restart: chart only,
        # no reconcile claim
        final = obs.finalize(None if ck is not None else state, steps=ran,
                             wall=dt)
        if is_coordinator():
            write_merged_summary(args.obs_dir)
        p0print(f"obs: {args.obs_dir} "
                f"spc_reconciled={final.get('reconciled', 'n/a')} "
                f"accel_events={final['accel_events']}")
    if resolved is not None:
        p0print(f"activations: {resolved.seen}")
    p0print(f"done: {ran} steps in {dt:.1f}s "
            f"({dt/ran*1e3:.0f} ms/step) "
            f"accelerated={int(state.accel_count)} "
            f"sub_iters={int(state.sub_iters)}")
    cuda = dev.type == "cuda"
    return {"log": log, "batch_idx": picks, "state": state,
            "sched_state": sched_state, "model": model, "seconds": dt,
            "placement": placement, "local_params": carry[1],
            "tp_bytes": None if placement is None else {
                "sums": init_fn.strategy.tp.moved,
                "gathers_per_eval": placement.gather_bytes()},
            "steps": steps, "start": start,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            "peak_reserved": torch.cuda.max_memory_reserved(dev) if cuda else None,
            "params": n_params, "capture_seconds": capture,
            "chunk_steps": k if fused else 1, "obs": final, "ranks": ranks,
            "reduce_bytes": None if mesh is None
            else init_fn.reduce_ctx.buffer_bytes}


def _run_async(args, dev, cfg, model, dtype, layout, *, profiler=None,
               snapshot_hook=None) -> dict:
    """``--engine async-ps``: the reference's ``run_async_ps``. ``model`` is
    worker 0's replica (and ``params0``, which the server copies); workers
    1… get replicas of their own. The warm-up runs before the clock and
    before the peak-memory count; ``profiler`` is entered around the run
    only. After the run the model holds the server's canonical params.
    -> ``_run``'s dict (``steps``: the server's version at the end,
    ``start``: the resumed version, else 0; ``log``: the push records in
    commit order, ``records_to_trainlog``), with ``records``, ``events``,
    ``workers`` and ``warmup_seconds``."""
    from repro_torch.core.isgd import assign_, isgd_init
    from repro_torch.core.reduce import staleness_reduce_from_spec
    from repro_torch.distributed.async_ps.coordinator import (
        AsyncPSCoordinator, records_to_trainlog, snapshot_engine_kwargs,
        snapshot_from_checkpoint)
    from repro_torch.fault.plan import FaultPlan

    refuse_async(args, cfg)
    params = model.params()
    n_params = sum(p.numel() for p in params)
    data = make_lm_tokens(0, args.n_seqs, args.seq, cfg.vocab_size)
    sampler = FCPRSampler(data, batch_size=args.batch, seed=1)
    if sampler.n_batches % args.workers:
        # legal since re-striping: the strided shards still cover the
        # global cycle, ownership just rotates (see ShardedFeed)
        p0print(f"note: n_batches={sampler.n_batches} not a multiple of "
                f"--workers {args.workers}; per-worker batch ownership "
                f"rotates through the FCPR cycle")
    faults = None
    if args.fault_plan:
        faults = FaultPlan.from_spec(args.fault_plan)
        p0print(f"faults: {faults}")
    rctx = staleness_reduce_from_spec(args.staleness_decay)
    p0print(f"arch={cfg.name} engine=async-ps workers={args.workers} "
            f"max_staleness={args.max_staleness} "
            f"w(tau)={args.staleness_decay} elastic={args.elastic} "
            f"deadline={args.deadline:.0f}s device={dev} "
            f"kernels={args.kernels} precision={args.precision} "
            f"remat={args.remat}")
    p0print(f"params: {n_params/1e6:.1f}M (canonical copy on the server, "
            f"a replica a worker)")
    if args.kernels == "cuda" and dev.type == "cuda":
        build.build_all()
    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=args.k_sigma,
                      stop=args.stop)
    rule, lr_fn = RULES[args.rule](), constant_lr(args.lr)
    obs = _make_observer(args, cfg, icfg, "async-ps",
                         replay_exact=args.workers == 1)
    recorder = obs.recorder if obs is not None else None
    ckpt = _make_checkpointer(args, layout, recorder=recorder)

    def replica(w):
        if w == 0:
            return params, model.loss_fn
        m = build_model(cfg, kernels=args.kernels, param_dtype=dtype,
                        remat=args.remat != "none", device=dev)
        m.init(0)
        return m.params(), m.loss_fn

    coord = AsyncPSCoordinator(
        replica, rule, icfg, workers=args.workers,
        max_staleness=args.max_staleness, lr_fn=lr_fn, reduce_ctx=rctx,
        inconsistent=not args.consistent, elastic=args.elastic,
        deadline_s=args.deadline, verify_pushes=args.verify_pushes,
        recorder=recorder, snapshot_hook=snapshot_hook,
        **({} if faults is None else {"faults": faults}))
    resume, start = None, 0
    if args.resume and ckpt is not None:
        latest = ckpt.latest()
        if latest is None:
            p0print(f"resume: no checkpoint under {ckpt.directory!r}; "
                    f"starting fresh")
        else:
            ck = restore_engine(latest, params_like=params,
                                state_like=isgd_init(rule, icfg, params),
                                layout=layout, recorder=ckpt.recorder)
            ckpt.mark(ck.step)
            resume = snapshot_from_checkpoint(ck)
            start = resume["version"]
            p0print(f"resume: restored {latest!r} at server version "
                    f"{ck.server['version']} (worker push clocks: "
                    f"{ck.server['pushed']})")
    run_kw = {}
    if ckpt is not None:
        def checkpoint_fn(snap):
            kw = snapshot_engine_kwargs(snap)
            ckpt.maybe_save(kw.pop("step"), **kw)
        # every push is offered; the checkpointer keeps its own cadence
        run_kw = dict(checkpoint_fn=checkpoint_fn, checkpoint_every=1)
    t0 = time.perf_counter()
    coord.warmup(params, sampler)
    warm = time.perf_counter() - t0
    p0print(f"warmup: {warm:.1f}s (propose, the subproblem, the server's "
            f"observe and folds)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with profiler if profiler is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        final, state, records = coord.run(params, sampler, args.steps,
                                          resume=resume, **run_kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    with torch.no_grad():
        assign_(params, final)            # the trained model: canonical
    for ev in coord.events:
        p0print(f"event: {ev}")
    for i, r in enumerate(records):
        if (i + 1) % 5 == 0 or i == 0:
            p0print(f"push {i+1:4d} w{r['worker']} tau={r['tau']} "
                    f"loss={r['loss']:.4f} psi_bar={r['psi_bar']:.4f} "
                    f"limit={r['limit']:.4f} accel={r['accelerated']}")
    taus = [r["tau"] for r in records] or [0]
    p0print(f"staleness: mean_tau={sum(taus)/len(taus):.2f} "
            f"max_tau={max(taus)} "
            f"bound={(2 * args.max_staleness + 1) * (args.workers - 1)}")
    ran = max(len(records), 1)
    final_obs = None
    if obs is not None:
        obs.async_run(records, coord.events)
        # a resumed run missed the pushes before the restart: chart only
        final_obs = obs.finalize(None if resume is not None else state,
                                 steps=len(records), wall=dt)
        write_merged_summary(args.obs_dir)
        p0print(f"obs: {args.obs_dir} "
                f"spc_reconciled={final_obs.get('reconciled', 'n/a')} "
                f"accel_events={final_obs['accel_events']}")
    p0print(f"done: {len(records)} steps in {dt:.1f}s "
            f"({dt/ran*1e3:.0f} ms/step) "
            f"accelerated={int(state.accel_count)} "
            f"sub_iters={int(state.sub_iters)}")
    cuda = dev.type == "cuda"
    return {"log": records_to_trainlog(records), "batch_idx": [],
            "state": state, "sched_state": None, "model": model,
            "seconds": dt, "placement": None, "local_params": params,
            "tp_bytes": None, "steps": coord.server.version, "start": start,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            "peak_reserved": torch.cuda.max_memory_reserved(dev) if cuda else None,
            "params": n_params, "capture_seconds": 0.0, "chunk_steps": 1,
            "obs": final_obs, "ranks": 0, "reduce_bytes": None,
            "records": records, "events": coord.events,
            "workers": args.workers, "warmup_seconds": warm}


class _WholeTensors:
    """A checkpointer of a tensor-parallel run: every save gathers the
    placed params and the rule state into whole tensors first, so the file
    is the reference's format and every rank holds the same values (rank 0
    writes them, the others validate)."""

    def __init__(self, ckpt, placement):
        self.ckpt, self.placement = ckpt, placement

    def __getattr__(self, name):
        return getattr(self.ckpt, name)

    def maybe_save(self, step, *, state, params, sched_state=None):
        ckpts = getattr(self.ckpt, "ckpts", [self.ckpt])
        if not any(c.every and int(step) // c.every > c._last // c.every
                   for c in ckpts):
            return None               # the gather only where a save is due
        pl = self.placement
        return self.ckpt.maybe_save(
            step, params=pl.full(params),
            state=state._replace(base=pl.full_tree(state.base)),
            sched_state=sched_state)


def _print_step(j: int, log, **extra):
    more = "".join(f" {k}={v}" for k, v in extra.items())
    p0print(f"step {j:4d} loss={log.losses[-1]:.4f} "
            f"psi_bar={log.psi_bar[-1]:.4f} limit={log.limits[-1]:.4f} "
            f"accel={log.accelerated[-1]}{more}", flush=True)


def _offer(ckpt, j: int, carry) -> None:
    """Offer ``ckpt`` (if any) the boundary after step ``j``: ``carry``
    is ``(state, params[, sched_state])``."""
    if ckpt is not None:
        ckpt.maybe_save(j, state=carry[0], params=carry[1],
                        sched_state=carry[2] if len(carry) > 2 else None)


def _drive_chunks(chunk_fn, carry, ring, steps: int, k: int, t0,
                  start: int = 0, ckpt=None, on_chunk=None, obs=None):
    """Run from global step ``start`` to ``steps`` (rounded up to whole
    chunks) through the fused engine, ``carry`` being ``(state,
    params[, sched_state])``, printing the last step of each chunk (and a
    scheduled chunk's ``visits=``). ``start`` may sit mid-chunk relative to
    the K grid: ``chunk_fn`` takes any ``j0`` (what makes resuming from a
    checkpoint possible). ``host_metrics`` is the one host read per chunk:
    it waits for the chunk, so the wall taken after it is the chunk's end.
    The log and ``obs`` (a ``TrainObserver``) take its host arrays;
    ``ckpt`` is offered the chunk boundary; then ``on_chunk()`` if given.
    -> (carry, last step run, log, batch picks)."""
    from repro_torch.sched.engine import selection_counts
    log, picks = TrainLog(), []
    j = start
    while j < steps:
        *carry, ms = chunk_fn(*carry, ring.arrays, j)
        host = host_metrics(ms)
        log.extend(host, time.perf_counter() - t0)
        if obs is not None:
            obs.chunk(j, host)
        j += k
        extra = {}
        if "batch_idx" in host:
            picks += host["batch_idx"].astype(int).tolist()
            extra["visits"] = selection_counts(host["batch_idx"],
                                               ring.n_batches).tolist()
        _print_step(j, log, **extra)
        _offer(ckpt, j, carry)
        if on_chunk is not None:
            on_chunk()
    return tuple(carry), j, log, picks


def _drive_steps(one_step, carry, steps: int, t0, *, start: int = 0,
                 ckpt=None, obs=None, on_step=None):
    """The per-step engines from ``start`` to ``steps``: ``one_step(carry,
    j) -> (carry, metrics)``. Metrics stay on the device until the print
    boundaries (step 1 and every 5th) and the end, as ``train`` defers them
    (``trainer.Deferred``), and the log marks the walls estimated; a
    scheduled step's pick is printed (``batch=``). ``ckpt`` is offered
    every step boundary, then ``on_step(j + 1, carry)`` runs if given.
    -> (carry, last step run, log, batch picks)."""
    log, picks = TrainLog(), []
    deferred = Deferred(log, obs)

    def flush():
        picks.extend(int(r["batch_idx"]) for r in deferred.flush()
                     if "batch_idx" in r)

    for j in range(start, steps):
        carry, m = one_step(carry, j)
        deferred.add(j, m, time.perf_counter() - t0)
        if j == start or (j + 1) % 5 == 0:
            flush()
            _print_step(j + 1, log,
                        **({"batch": picks[-1]} if picks else {}))
        _offer(ckpt, j + 1, carry)
        if on_step is not None:
            on_step(j + 1, carry)
    flush()
    return carry, steps, log, picks


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    try:
        resolve_device(args.device)
        cfg = resolve_config(args)
        if engine_of(args) == "async-ps":
            refuse_async(args, cfg)
        if args.schedule is not None:
            schedule_from_spec(args.schedule)
    except (RuntimeError, ValueError, TypeError) as e:   # the CLI boundary
        raise SystemExit(f"error: {e}") from None
    return run(args)


if __name__ == "__main__":
    main()
