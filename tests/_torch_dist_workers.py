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


def _scatter_shards(world: int, seed: int) -> dict:
    """Every rank's leaves for the reduce-scatter's layouts: whole leaves
    of 5·3 + 7 + 1 = 23 elements (23 divides none of 2, 3, 4), and leaves
    sliced over ``data`` (``data`` ranks slices each); "y" and "v" are
    sent as bf16."""
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(world, 5, 3).astype(np.float32),
            "y": rng.randn(world, 7).astype(np.float32),
            "z": rng.randn(world, 1).astype(np.float32),
            "u": rng.randn(world, 4 * world, 5).astype(np.float32),
            "v": rng.randn(world, 4, 3 * world).astype(np.float32),
            "w": rng.randn(world, 6, 4).astype(np.float32)}


def scatter_parts(rank: int, world: int, data: int, pod_group=None):
    """The ``Parts`` of the sliced layout on this rank, data rank c = rank
    mod ``data``: "u" (4·world, 5) by rows, 4·world/data a slice; "v" (4,
    3·world) rows 0:2 only (another axis' slice) and its columns by data
    rank; "y" whole; "w" (6, 4) columns 2:4 on every rank."""
    from repro_torch.core.reduce import Parts
    c, ru, cv = rank % data, 4 * world // data, 3 * world // data
    return Parts(((0, ((c * ru, (c + 1) * ru), (0, 5))),
                  (1, ((0, 2), (c * cv, (c + 1) * cv))),
                  None,
                  (None, ((0, 6), (2, 4)))), data, pod_group)


def scatter_rank(rank, world, seed):
    """The reduce-scatter of ``AxisReduce`` on this rank (``all_reduce``
    refused): the whole layout (``tree``), the sliced layout with every
    rank a data rank, and at four ranks the pod layout (2 pods × 2 data
    ranks) -> each layout's means, dtypes and ``buffer_bytes``."""
    import torch.distributed as dist

    from repro_torch.core.reduce import AxisReduce

    def refuse(*a, **k):
        raise AssertionError("AxisReduce called all_reduce")
    dist.all_reduce = refuse
    s = _scatter_shards(world, seed)
    bf16 = torch.bfloat16
    out = {}
    ctx = AxisReduce("data", deterministic=True)
    got = ctx.tree([torch.from_numpy(s["x"][rank]),
                    torch.from_numpy(s["y"][rank]).to(bf16),
                    torch.from_numpy(s["z"][rank])])
    out["whole"] = ([_np(t) for t in got], [str(t.dtype) for t in got],
                    ctx.buffer_bytes)
    sliced = [torch.from_numpy(s["u"][rank]),
              torch.from_numpy(s["v"][rank]).to(bf16),
              torch.from_numpy(s["y"][rank]),
              torch.from_numpy(s["w"][rank])]
    layouts = {"sliced": (world, None)}
    if world == 4:
        groups = [dist.new_group([c, 2 + c]) for c in range(2)]
        layouts["pods"] = (2, groups[rank % 2])
    for name, (data, pod_group) in layouts.items():
        ctx = AxisReduce("data", deterministic=True)
        parts = scatter_parts(rank, world, data, pod_group)
        got = ctx._reduce(sliced, parts=parts)
        out[name] = ([_np(t) for t in got], [str(t.dtype) for t in got],
                     ctx.buffer_bytes, parts.leaves)
    return out


def nccl_scatter_rank(rank, world, seed):
    """``scatter_rank``'s layouts on this rank's card over NCCL (one card a
    rank), and the sliced layout captured in a CUDA graph and replayed on
    twice the shards -> each layout's means and dtypes, the replay's
    means."""
    import torch.distributed as dist

    from repro_torch.core.reduce import AxisReduce
    dev = torch.device("cuda", torch.cuda.current_device())
    s = _scatter_shards(world, seed)
    bf16 = torch.bfloat16

    def put(key, dtype=torch.float32):
        return torch.from_numpy(s[key][rank]).to(dev, dtype)
    out = {}
    ctx = AxisReduce("data", deterministic=True)
    got = ctx.tree([put("x"), put("y", bf16), put("z")])
    out["whole"] = ([_np(t.cpu()) for t in got], [str(t.dtype) for t in got])
    sliced = [put("u"), put("v", bf16), put("y"), put("w")]
    layouts = {"sliced": (world, None)}
    if world == 4:
        groups = [dist.new_group([c, 2 + c]) for c in range(2)]
        layouts["pods"] = (2, groups[rank % 2])
    for name, (data, pod_group) in layouts.items():
        ctx = AxisReduce("data", deterministic=True)
        parts = scatter_parts(rank, world, data, pod_group)
        got = ctx._reduce(sliced, parts=parts)
        out[name] = ([_np(t.cpu()) for t in got], [str(t.dtype) for t in got],
                     parts.leaves)
    ctx = AxisReduce("data", deterministic=True)
    parts = scatter_parts(rank, world, world)
    static = [t.clone() for t in sliced]
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ctx._reduce(static, copy=False, parts=parts)     # buffers, comms
        with torch.cuda.graph(graph, stream=side):
            res = ctx._reduce(static, copy=False, parts=parts)
    torch.cuda.current_stream().wait_stream(side)
    for t, x in zip(static, sliced):
        t.copy_(x * 2)
    graph.replay()
    torch.cuda.synchronize()
    out["captured"] = [_np(t.cpu()) for t in res]
    return out


def tp_slices_rank(rank, world, model, pods):
    """One evaluation of the wide tiny transformer (f32, plain paths)
    through the hybrid engine's reduction on the ``(pods, world/(pods·
    model), model)`` training mesh (``pods`` nodes of ranks) -> this
    rank's unreduced loss and compute gradients, its reduced ψ and local
    gradients, its ``Parts``, its local shard shapes and the global ranks
    of its data group in group order."""
    import os

    import torch.distributed as dist
    if pods > 1:
        os.environ["LOCAL_WORLD_SIZE"] = str(world // pods)
    from repro_torch.distributed.data_parallel import mesh_strategy
    from repro_torch.launch.mesh import make_training_mesh, mesh_group
    from repro_torch.launch.shardings import hybrid_params_placement
    from repro_torch.models import build_model
    cfg = tiny_tp_config(True)
    m = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                    device="cpu")
    m.init(0)
    mesh = make_training_mesh(model, device="cpu")
    local, pl = hybrid_params_placement(mesh, m.module)
    strat = mesh_strategy(mesh)
    strat.bind(local)
    strat.prime(local)
    sampler = FCPRSampler(make_lm_tokens(0, 16, 32, cfg.vocab_size),
                          batch_size=4, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in sampler(0).items()}
    raw = {}

    def lg(params, b):
        total, aux = m.loss_fn(b)
        grads = torch.autograd.grad(total, params)
        raw["loss"] = float(total.detach())
        raw["grads"] = [_np(g) for g in grads]
        return (total.detach().float(), aux.detach().float()), grads
    (loss, _), grads = strat.reduce_ctx.wrap_loss_and_grad(lg)(local, batch)
    return {"raw": raw, "loss": float(loss), "grads": [_np(g) for g in grads],
            "parts": strat.reduce_ctx.parts().leaves,
            "local_shapes": [tuple(t.shape) for t in local],
            "group": dist.get_process_group_ranks(mesh_group(mesh)),
            "mesh": tuple(mesh.shape)}


def check_local_grads_are_slices(ranks: list) -> int:
    """Hold ``tp_slices_rank``'s results: every rank's ψ is the rank-order
    ``shard_mean`` of its data group's unreduced losses, and each local
    gradient is exactly its part (``Parts``) of the ``shard_mean`` of the
    group's unreduced gradients, computed here in rank order, bit for bit
    -> the number of leaves a rank got as a data slice."""
    from repro_torch.core.reduce import shard_mean
    sliced = 0
    for r, got in enumerate(ranks):
        group = got["group"]
        assert r in group and len(group) > 1
        psi = shard_mean(torch.tensor([ranks[q]["raw"]["loss"]
                                       for q in group]))
        assert got["loss"] == float(psi), (r, got["loss"], float(psi))
        for i, (mine, entry) in enumerate(zip(got["grads"], got["parts"])):
            rows = torch.from_numpy(np.stack([ranks[q]["raw"]["grads"][i]
                                              for q in group]))
            full = shard_mean(rows).numpy()
            want = full if entry is None else full[tuple(
                slice(a, b) for a, b in entry[1])]
            assert mine.shape == want.shape == got["local_shapes"][i]
            np.testing.assert_array_equal(mine, want,
                                          err_msg=f"rank {r} leaf {i}")
            sliced += entry is not None and entry[0] is not None
    return sliced // len(ranks)


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
    transformer on ``(2, 2)``, the fused tensor-parallel engine and the
    data mean's slices (``tp_slices_rank``)."""
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
            "fused": tp_fused_rank(rank, world, 2, 8, 4),
            "slices": tp_slices_rank(rank, world, 2, 1)}


TP_ATTENTION = {"even": dict(d_model=128, head_dim=32, num_heads=4,
                             num_kv_heads=2, d_ff=256),
                "uneven": dict(d_model=128, head_dim=32, num_heads=6,
                               num_kv_heads=2, d_ff=256)}


def tp_attention_config(kind: str):
    """The configs of ``tests/test_torch_tp_attention.py``: the tiny
    transformer widened (``TP_ATTENTION``: H 4 or 6 over K 2) or
    whisper's reduced config (``whisper``)."""
    import dataclasses

    from repro_torch.configs import get_config, zoo_config
    if kind == "whisper":
        return get_config("whisper_medium").reduced()
    return dataclasses.replace(zoo_config("transformer", "tiny"),
                               **TP_ATTENTION[kind])


def tp_attention_batches(cfg, steps: int) -> list:
    """The global batches of the tensor-parallel attention legs: 4 rows of
    32 tokens from the FCPR sampler, and for an enc-dec config seeded
    frames (4, encoder_seq, d), the same numpy arrays on every side."""
    sampler = FCPRSampler(make_lm_tokens(0, 16, 32, cfg.vocab_size),
                          batch_size=4, seed=1)
    rng = np.random.RandomState(3)
    out = []
    for j in range(steps):
        b = dict(sampler(j))
        if cfg.family == "encdec":
            b["frontend_embeds"] = rng.randn(
                4, cfg.encoder_seq, cfg.d_model).astype(np.float32)
        out.append(b)
    return out


def tp_attention_rank(rank, world, state_dict_path, kind, model, steps,
                      lr):
    """``tp_attention_config(kind)`` (f32, plain paths) through the hybrid
    engine on the ``(world/model, model)`` mesh from the params in
    ``state_dict_path`` -> (losses, limits, accelerated, the whole final
    state dict, {leaf name: (compute shape, local shape, narrow)} of the
    split attention leaves, the bytes the KV-group and model-axis
    exchanges moved, and whether the whole params and velocity come back
    to the same local shards through ``load_full`` and
    ``load_full_tree``, as a checkpoint's restore takes them)."""
    from repro_torch.distributed import make_hybrid_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import hybrid_params_placement
    from repro_torch.models import build_model
    cfg = tp_attention_config(kind)
    m = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                    device="cpu")
    m.init(0, max_seq=32)
    with np.load(state_dict_path) as f:
        m.module.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files})
    names = [n for n, _ in m.module.named_parameters()]
    mesh = make_host_mesh(model=model, device="cpu")
    local, pl = hybrid_params_placement(mesh, m.module)
    icfg = ISGDConfig(n_batches=4, k_sigma=1.0, stop=2)
    init, step = make_hybrid_step(m.loss_fn, momentum(0.9), icfg, mesh,
                                  lr_fn=constant_lr(lr))
    state = init(local)
    losses, limits, accel = [], [], []
    for b in tp_attention_batches(cfg, steps):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        state, local, met = step(state, local, batch)
        losses.append(float(met["loss"]))
        limits.append(float(met["limit"]))
        accel.append(bool(met["accelerated"]))
    full = dict(zip(names, (_np(t) for t in pl.full())))
    split = {lf.name: (tuple(lf.compute.shape), tuple(lf.local.shape),
                       lf.narrow)
             for lf in pl.leaves if lf.tp_dim is not None
             and lf.name.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo")}
    moved = init.strategy.tp.moved
    back = [torch.full_like(t, float("nan")) for t in local]
    pl.load_full(pl.full(), back)
    base = [torch.full_like(t, float("nan")) for t in state.base]
    pl.load_full_tree(pl.full_tree(state.base), base)
    restored = all(torch.equal(a, b) for a, b in zip(back + base,
                                                     local + state.base))
    return losses, limits, accel, full, split, moved, restored


AXIS_SUM_SHAPES = [(5, 3), (7,), (2, 3, 4)]


def axis_sum_rank(rank, world, seed):
    """``core.reduce.axis_sum`` over the group of this rank's draws, f32
    and bf16, at ``AXIS_SUM_SHAPES`` (sizes 15, 7 and 24: none divides 2,
    3 and 4 all) -> [(every rank's input, the sum), ...] as numpy f32."""
    from repro_torch.core.reduce import axis_sum
    rng = np.random.RandomState(seed)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in AXIS_SUM_SHAPES:
            xs = [torch.from_numpy(rng.randn(*shape).astype(np.float32) * 10)
                  .to(dtype) for _ in range(world)]
            got = axis_sum(xs[rank], None)
            assert got.dtype == dtype and got.shape == xs[rank].shape
            out.append(([_np(x) for x in xs], _np(got)))
    return out
