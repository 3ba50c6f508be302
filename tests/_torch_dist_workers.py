"""Rank functions of the data-parallel tests.

Each runs on a process of its own (``repro_torch.launch.env.spawn_ranks``:
a gloo group on the CPU joined through a file store) and returns numpy
values to the test. This module imports torch and ``repro_torch`` only, so
a spawned rank never loads jax.
"""
import numpy as np
import torch

from repro_torch.core import ISGDConfig, constant_lr
from repro_torch.data import FCPRSampler, make_lm_tokens
from repro_torch.optim import momentum


def _shards(world: int, seed: int) -> dict:
    """Every rank's inputs, drawn from one seed (each rank uses its own)."""
    rng = np.random.RandomState(seed)
    return {"scalar": (rng.randn(world) * 10).astype(np.float32),
            "a": rng.randn(world, 5, 3).astype(np.float32),
            "b": rng.randn(world, 7).astype(np.float32),      # sent as bf16
            "g0": rng.randn(world, 4, 6).astype(np.float32),
            "g1": rng.randn(world, 9).astype(np.float32),     # sent as bf16
            "loss": (rng.rand(world) * 5).astype(np.float32),
            "aux": rng.rand(world).astype(np.float32)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def reduce_rank(rank, world, seed):
    """``AxisReduce`` over the group on this rank's shards: scalar, tree,
    the flat bucket of ``wrap_loss_and_grad`` and ``sum_scalar``."""
    from repro_torch.core.reduce import AxisReduce
    s = _shards(world, seed)
    ctx = AxisReduce("data", deterministic=True)
    bf16 = torch.bfloat16
    out = {"scalar": _np(ctx.scalar(torch.tensor(s["scalar"][rank]))),
           "sum": _np(ctx.sum_scalar(torch.tensor(s["scalar"][rank])))}
    tree = ctx.tree({"a": torch.from_numpy(s["a"][rank]),
                     "b": [torch.from_numpy(s["b"][rank]).to(bf16)]})
    out["a"], out["b"] = _np(tree["a"]), _np(tree["b"][0])
    out["b_dtype"] = str(tree["b"][0].dtype)

    def lg(params, batch):
        grads = (torch.from_numpy(s["g0"][rank]),
                 torch.from_numpy(s["g1"][rank]).to(bf16))
        return ((torch.tensor(s["loss"][rank]), torch.tensor(s["aux"][rank])),
                grads)
    (loss, aux), grads = ctx.wrap_loss_and_grad(lg)(None, None)
    out.update(loss=_np(loss), aux=_np(aux), g0=_np(grads[0]),
               g1=_np(grads[1]), g1_dtype=str(grads[1].dtype),
               buffer_bytes=ctx.buffer_bytes)
    return out


def _regression(batch_size=32, n_batches=4, dim=6):
    rng = np.random.RandomState(0)
    xs = rng.randn(batch_size * n_batches, dim).astype(np.float32)
    ys = ((xs @ rng.randn(dim, 1).astype(np.float32)).ravel()
          / np.sqrt(dim)).astype(np.float32)
    ys[:batch_size] += 3.0
    sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=batch_size, seed=1)
    icfg = ISGDConfig(n_batches=n_batches, k_sigma=1.0, stop=3, zeta=0.01)

    def make():
        params = [torch.zeros(dim, requires_grad=True),
                  torch.zeros((), requires_grad=True)]

        def loss_fn(batch):
            loss = torch.mean((batch["x"] @ params[0] + params[1]
                               - batch["y"]) ** 2)
            return loss, loss
        return params, loss_fn
    return make, sampler, icfg


def _lr_fn(psi_bar):
    return 0.01 + 0.001 * torch.clamp(psi_bar, max=1.0)


def feeds_rank(rank, world, steps):
    """The data layer and the engines on this rank: the ring stripe, the
    ring's and the prefetcher's rows of each batch, and the per-step and
    fused data-parallel engines (micro_batches 1 and 2) on the regression
    problem, their logs and final params."""
    from repro_torch.data import DeviceRing
    from repro_torch.distributed import (make_chunked_data_parallel_step,
                                         make_data_parallel_step, prefetched)
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.train.trainer import host_metrics
    mesh = make_data_mesh("cpu")
    make, sampler, icfg = _regression()
    ring = DeviceRing(sampler.epoch_arrays(), sampler.batch_size, mesh=mesh)
    feed = prefetched(sampler, mesh, device="cpu")
    out = {"stripe": {k: v.numpy() for k, v in ring.arrays.items()},
           "ring_rows": [{k: v.numpy().copy() for k, v in ring(j).items()}
                         for j in range(6)],
           "prefetch_rows": [{k: v.numpy() for k, v in feed(j).items()}
                             for j in range(6)],
           "local_block": ring.local_block}
    keys = ("loss", "psi_bar", "limit", "accelerated", "sub_iters")
    for mb in (1, 2):
        params, loss_fn = make()
        init, step = make_data_parallel_step(loss_fn, momentum(0.9), icfg,
                                             mesh, lr_fn=_lr_fn,
                                             micro_batches=mb)
        state, rows = init(params), []
        for j in range(steps):
            state, params, m = step(state, params, feed(j))
            rows.append(host_metrics(m))
        per_step = {k: np.array([r[k] for r in rows]) for k in keys}
        fp, loss_fn = make()
        init, chunk = make_chunked_data_parallel_step(
            loss_fn, momentum(0.9), icfg, mesh, chunk_steps=4, lr_fn=_lr_fn,
            micro_batches=mb)
        fs, chunks = init(fp), []
        for c in range(steps // 4):
            fs, fp, ms = chunk(fs, fp, ring.arrays, c * 4)
            chunks.append(host_metrics(ms))
        fused = {k: np.concatenate([c[k] for c in chunks]) for k in keys}
        out[f"mb{mb}"] = {
            "per_step": per_step, "fused": fused,
            "params": [_np(p) for p in params],
            "fused_params": [_np(p) for p in fp]}
    return out


def transformer_rank(rank, world, state_dict_path, steps, lr):
    """``paper-transformer-tiny`` (f32, plain paths) through the
    data-parallel engine on this rank's rows, from the params in
    ``state_dict_path`` -> (losses, limits, accelerated, final state dict
    as numpy)."""
    from repro_torch.configs import zoo_config
    from repro_torch.distributed import make_data_parallel_step, prefetched
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models import build_model
    cfg = zoo_config("transformer", "tiny")
    m = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                    device="cpu")
    with np.load(state_dict_path) as f:
        m.module.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files})
    mesh = make_data_mesh("cpu")
    sampler = FCPRSampler(make_lm_tokens(0, 16, 32, cfg.vocab_size),
                          batch_size=4, seed=1)
    icfg = ISGDConfig(n_batches=4, k_sigma=1.0, stop=2)
    params = m.params()
    init, step = make_data_parallel_step(m.loss_fn, momentum(0.9), icfg, mesh,
                                         lr_fn=constant_lr(lr))
    state, feed = init(params), prefetched(sampler, mesh, device="cpu")
    losses, limits, accel = [], [], []
    for j in range(steps):
        state, params, met = step(state, params, feed(j))
        losses.append(float(met["loss"]))
        limits.append(float(met["limit"]))
        accel.append(bool(met["accelerated"]))
    return losses, limits, accel, {k: v.detach().numpy().copy()
                                   for k, v in m.module.state_dict().items()}


def validate_rank(rank, world, directory, perturb):
    """Rank 0 writes, the others validate; with ``perturb`` rank 1 moves its
    replica off before the second save. -> (role, first save ok, the
    second save's error or None)."""
    from repro_torch.core import isgd_init
    from repro_torch.train import checkpoints
    make, _, icfg = _regression()
    params, _ = make()
    with torch.no_grad():
        params[0].add_(1.0)
    state = isgd_init(momentum(0.9), icfg, params)
    layout = checkpoints.named_layout(["w", "b"])
    ck = checkpoints.Checkpointer(directory, layout=layout)
    first = ck.save(4, params=params, state=state)
    if perturb and rank == 1:
        with torch.no_grad():
            params[0][0] += 1e-3
    try:
        ck.save(8, params=params, state=state)
        err = None
    except checkpoints.CheckpointError as e:
        err = str(e)
    return ck.role, first, err


# ---------------------------------------------------------------------------
# the hybrid DP × TP engine (tests/test_torch_hybrid.py)
# ---------------------------------------------------------------------------
def _hybrid_regression(batch_size):
    """The dim-6 problem of ``repro_torch.distributed.hybrid_parity`` (its
    ψ̄-dependent LR), feeding batches as tensors."""
    from repro_torch.distributed.hybrid_parity import _lr_fn, _problem
    sampler, make, _, _ = _problem(batch_size // 8, torch.device("cpu"),
                                   np.random.RandomState(0))
    icfg = ISGDConfig(n_batches=4, k_sigma=1.0, stop=3, zeta=0.01)
    return sampler, make, icfg, _lr_fn


def _run_steps(step, init, params, feed, steps=32):
    from repro_torch.train.trainer import host_metrics
    state, rows = init(params), []
    for j in range(steps):
        batch = {k: torch.as_tensor(v) for k, v in feed(j).items()}
        state, params, m = step(state, params, batch)
        rows.append(host_metrics(m))
    keys = ("loss", "limit", "psi_bar", "accelerated", "sub_iters")
    return ({k: np.array([r[k] for r in rows]) for k in keys},
            [_np(p) for p in params], int(state.accel_count))


def hybrid_mesh_rank(rank, world, leg):
    """One leg of the hybrid engine's tests on this rank:

    * ``model1``: the data-parallel engine on the 1-D mesh against the
      hybrid engine on ``(world, 1)``, both on this rank's rows;
    * ``pure_tp``: the hybrid engine on ``(1, world)`` (the tensor-parallel
      strategy, the toy params replicated) on the global batch;
    * ``chunked``: per-step against fused on ``(world, 1)`` over the ring;
    * ``ring``: the ring's batches, relaid out and in global row order."""
    from repro_torch.data import DeviceRing
    from repro_torch.distributed import (batch_sharding,
                                         make_chunked_hybrid_step,
                                         make_data_parallel_step,
                                         make_hybrid_step, tensor_axes)
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh
    from repro_torch.launch.shardings import hybrid_params_placement
    from repro_torch.train.trainer import host_metrics
    bs = 8 * world
    sampler, make, icfg, lr_fn = _hybrid_regression(bs)
    rule = momentum(0.9)
    if leg == "model1":
        dmesh = make_data_mesh("cpu")
        hmesh = make_host_mesh(model=1, device="cpu")
        cut = batch_sharding(hmesh)
        out = []
        for mesh in (dmesh, hmesh):
            params, loss_fn = make()
            init, step = make_hybrid_step(loss_fn, rule, icfg, mesh,
                                          lr_fn=lr_fn)
            out.append(_run_steps(step, init, params,
                                  lambda j: cut(sampler(j))))
        return out, tensor_axes(hmesh)
    if leg == "pure_tp":
        mesh = make_host_mesh(model=world, device="cpu")
        params, loss_fn = make()
        local, pl = hybrid_params_placement(mesh, params)
        init, step = make_hybrid_step(loss_fn, rule, icfg, mesh, lr_fn=lr_fn)
        return _run_steps(step, init, local, sampler), tensor_axes(mesh)
    mesh = make_host_mesh(model=1, device="cpu")
    if leg == "ring":
        out = {}
        for relayout in (True, False):
            ring = DeviceRing(sampler.epoch_arrays(), bs, mesh=mesh,
                              relayout=relayout)
            out[relayout] = (ring.n_devices, ring.local_batch_size,
                             [{k: _np(v) for k, v in ring(j).items()}
                              for j in range(7)])
        return out, batch_sharding(mesh).rows(bs)
    cut = batch_sharding(mesh)
    params, loss_fn = make()
    init, step = make_hybrid_step(loss_fn, rule, icfg, mesh, lr_fn=lr_fn)
    ring = DeviceRing(sampler.epoch_arrays(), bs, mesh=mesh)
    ref = _run_steps(step, init, params, ring)
    params, loss_fn = make()
    cinit, chunk = make_chunked_hybrid_step(loss_fn, rule, icfg, mesh,
                                            chunk_steps=4, lr_fn=lr_fn)
    state, rows = cinit(params), []
    for c in range(8):
        state, params, ms = chunk(state, params, ring.arrays, c * 4)
        rows.append(host_metrics(ms))
    keys = ("loss", "limit", "psi_bar", "accelerated", "sub_iters")
    got = ({k: np.concatenate([r[k] for r in rows]) for k in keys},
           [_np(p) for p in params], int(state.accel_count))
    return ref, got


def sharded_tp_rank(rank, world, steps):
    """A (128, 8) weight split over ``model=2`` ((None, "model")) on the
    (world/2, 2) mesh, the problem of ``hybrid_parity``'s sharded-tp leg:
    -> (the gathered weight, the accelerations)."""
    from repro_torch.data import FCPRSampler
    from repro_torch.distributed import batch_sharding, make_hybrid_step
    from repro_torch.distributed.hybrid_parity import _lr_fn
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import hybrid_params_placement
    xs, ys, bs = sharded_tp_problem(world)
    smp = FCPRSampler({"x": xs, "y": ys}, batch_size=bs, seed=1)
    w = torch.zeros((128, 8), requires_grad=True)

    def loss_fn(batch):
        loss = torch.mean((batch["x"] @ w - batch["y"]) ** 2)
        return loss, loss
    mesh = make_host_mesh(model=2, device="cpu")
    local, pl = hybrid_params_placement(mesh, [w], names=["w"], fsdp=False)
    icfg = ISGDConfig(n_batches=4, k_sigma=1.0, stop=3, zeta=0.01)
    init, step = make_hybrid_step(loss_fn, momentum(0.9), icfg, mesh,
                                  lr_fn=_lr_fn)
    _, _, accel = _run_steps(step, init, local, smp, steps)
    return pl.specs["w"], _np(pl.full()[0]), accel, tuple(local[0].shape)


def sharded_tp_problem(world):
    """The (128, 8) regression of ``hybrid_parity``: its draws after the
    dim-6 problem's, from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    bs, nb = 8 * world, 4
    rng.randn(bs * nb, 6)
    rng.randn(6, 1)
    xs = rng.randn(bs * nb, 128).astype(np.float32)
    W = rng.randn(128, 8).astype(np.float32)
    ys = (xs @ W / np.sqrt(128)).astype(np.float32)
    ys[:bs] += 3.0
    return xs, ys, bs


def tp_transformer_rank(rank, world, state_dict_path, model, steps, lr,
                        wide):
    """``paper-transformer-tiny`` (f32, plain paths; ``wide``: d 128, four
    heads of 32, so the attention splits too) through the hybrid engine on
    the ``(world/model, model)`` mesh from the params in
    ``state_dict_path`` -> (losses, limits, accelerated, the whole final
    state dict, the names the model splits, the specs)."""
    from repro_torch.distributed import make_hybrid_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import hybrid_params_placement
    from repro_torch.models import build_model
    cfg = tiny_tp_config(wide)
    m = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                    device="cpu")
    with np.load(state_dict_path) as f:
        m.module.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files})
    names = [n for n, _ in m.module.named_parameters()]
    mesh = make_host_mesh(model=model, device="cpu")
    local, pl = hybrid_params_placement(mesh, m.module)
    sampler = FCPRSampler(make_lm_tokens(0, 16, 32, cfg.vocab_size),
                          batch_size=4, seed=1)
    icfg = ISGDConfig(n_batches=4, k_sigma=1.0, stop=2)
    init, step = make_hybrid_step(m.loss_fn, momentum(0.9), icfg, mesh,
                                  lr_fn=constant_lr(lr))
    state = init(local)
    losses, limits, accel = [], [], []
    for j in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in sampler(j).items()}
        state, local, met = step(state, local, batch)
        losses.append(float(met["loss"]))
        limits.append(float(met["limit"]))
        accel.append(bool(met["accelerated"]))
    full = dict(zip(names, (_np(t) for t in pl.full())))
    split = [lf.name for lf in pl.leaves if lf.tp_dim is not None]
    # the velocity shards like its parameter, the queue and counters whole
    from repro_torch.launch.shardings import state_shardings
    st = state_shardings(mesh, state, pl)
    assert st["base"] == [lf.spec for lf in pl.leaves]
    assert all(t.shape == p.shape for t, p in zip(state.base, local))
    assert st["queue"] == st["iter"] == ()
    return losses, limits, accel, full, split, pl.specs


def tiny_tp_config(wide: bool):
    import dataclasses

    from repro_torch.configs import zoo_config
    cfg = zoo_config("transformer", "tiny")
    if wide:
        cfg = dataclasses.replace(cfg, d_model=128, head_dim=32, d_ff=256)
    return cfg


def pod_mesh_rank(rank, world):
    """The training mesh of this rank as one of two nodes' ranks
    (``LOCAL_WORLD_SIZE`` = world / 2) -> its names, shape, data axes, data
    block, flat data group rank and size, and rank grid."""
    import os
    os.environ["LOCAL_WORLD_SIZE"] = str(world // 2)
    from repro_torch.launch.mesh import (data_axes, local_data_block,
                                         make_training_mesh, mesh_group)
    mesh = make_training_mesh(device="cpu")
    g = mesh_group(mesh)
    return (mesh.mesh_dim_names, tuple(mesh.shape), data_axes(mesh),
            local_data_block(mesh), g.rank(), g.size(), mesh.mesh.tolist())


def tp_fused_rank(rank, world, model, steps, k):
    """The wide tiny transformer (f32, plain paths) on the ``(world/model,
    model)`` mesh: the per-step hybrid engine on global batches against
    the fused one over the ring in global row order -> (per-step log,
    fused log, per-step whole params, fused whole params)."""
    from repro_torch.data import DeviceRing
    from repro_torch.distributed import (make_chunked_hybrid_step,
                                         make_hybrid_step)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import hybrid_params_placement
    from repro_torch.models import build_model
    from repro_torch.train.trainer import host_metrics
    cfg = tiny_tp_config(True)
    mesh = make_host_mesh(model=model, device="cpu")
    sampler = FCPRSampler(make_lm_tokens(0, 16, 32, cfg.vocab_size),
                          batch_size=4, seed=1)
    icfg = ISGDConfig(n_batches=4, k_sigma=-3.0, stop=2)   # trips fire
    keys = ("loss", "limit", "psi_bar", "accelerated", "sub_iters")
    out = []
    for fused in (False, True):
        m = build_model(cfg, kernels="cuda", param_dtype=torch.float32,
                        device="cpu")
        m.init(0)
        local, pl = hybrid_params_placement(mesh, m.module)
        if fused:
            ring = DeviceRing(sampler.epoch_arrays(), 4, mesh=mesh,
                              relayout=False)
            init, chunk = make_chunked_hybrid_step(
                m.loss_fn, momentum(0.9), icfg, mesh, chunk_steps=k,
                lr_fn=_lr_fn)
            state, rows = init(local), []
            for c in range(steps // k):
                state, local, ms = chunk(state, local, ring.arrays, c * k)
                rows.append(host_metrics(ms))
            log = {n: np.concatenate([r[n] for r in rows]) for n in keys}
        else:
            init, step = make_hybrid_step(m.loss_fn, momentum(0.9), icfg,
                                          mesh, lr_fn=_lr_fn)
            log, _, _ = _run_steps(step, init, local, sampler, steps)
        out.append((log, [_np(t) for t in pl.full()]))
    return out


def hybrid_suite_rank(rank, world, tiny_path, wide_path):
    """The hybrid engine's rank legs in one process a rank (one spawn
    for the whole test file): on two ranks the mesh legs, ``sharded-tp``
    and the tiny transformer on ``(1, 2)``; on four the tiny and the wide
    transformer on ``(2, 2)`` and the fused tensor-parallel engine."""
    if world == 2:
        out = {leg: hybrid_mesh_rank(rank, world, leg)
               for leg in ("model1", "pure_tp", "chunked", "ring")}
        out["sharded_tp"] = sharded_tp_rank(rank, world, 32)
        out["tiny"] = tp_transformer_rank(rank, world, tiny_path, 2, 3,
                                          0.05, False)
        return out
    return {"tiny": tp_transformer_rank(rank, world, tiny_path, 2, 3, 0.05,
                                        False),
            "wide": tp_transformer_rank(rank, world, wide_path, 2, 3, 0.05,
                                        True),
            "fused": tp_fused_rank(rank, world, 2, 8, 4)}
