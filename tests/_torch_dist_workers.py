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
