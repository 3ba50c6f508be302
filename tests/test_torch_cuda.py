"""The port's CUDA kernels on the card, against their plain versions, the
chunked engine's CUDA graph against the eager per-step engine, the
data-parallel engine on one NCCL rank, the hybrid and multi-host parity
harnesses on the card, and the serving slot engine's decode graph against
its eager decode.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one. The file imports neither jax nor the JAX package, and runs on a
machine that has neither:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are ``TOLERANCES[kernel][dtype]``; f32 products are kept out
of TF32.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import zoo_config
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention, gqa_flash)
from repro_torch.kernels.fused_xent import (fused_xent, fused_xent_sum,
                                            xent_plain)
from repro_torch.kernels.numerics import (ATTN_EDGES, ATTN_SHAPES, SSD_EDGES,
                                          SSD_SHAPES, TOLERANCES, XENT_EDGES,
                                          XENT_SHAPES, gqa_split)
from repro_torch.kernels.ssd_scan import (chunk_len, ssd_chunked_kernel,
                                          ssd_intra_chunk,
                                          ssd_intra_chunk_plain)
from repro_torch.models import build_model
from repro_torch.models.ssm import ssd_chunked

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(kernel, dtype):
    return TOLERANCES[kernel][str(dtype).split(".")[1]]


def _close(out, ref, tol):
    rtol, atol = tol
    torch.testing.assert_close(out.float().cpu(), ref.float().cpu(),
                               rtol=rtol, atol=atol)


def _xent_inputs(N, d, Vp, V, dtype, seed=0):
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(N, d).astype(np.float32))
    w = torch.from_numpy((rng.randn(d, Vp) * 0.05).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, V, size=N).astype(np.int32))
    return h.cuda().to(dtype), w.cuda().to(dtype), y.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", XENT_SHAPES, ids=str)
def test_xent_kernel_matches_plain(cuda, shape, dtype):
    N, d, Vp, V = shape
    h, w, y = _xent_inputs(*shape, dtype)
    n0 = fused_xent.launches
    out = fused_xent(h, w, y, V)
    torch.cuda.synchronize()
    assert fused_xent.launches == n0 + 1
    assert out.dtype == torch.float32 and out.shape == (N,)
    _close(out, xent_plain(h, w, y, V), _tol("fused_xent", dtype))
    wt = w.T.contiguous().T                      # a tied head: embed.T
    _close(fused_xent(h, wt, y, V), xent_plain(h, wt, y, V),
           _tol("fused_xent", dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", ATTN_SHAPES + [(4, 256, 128, True, None)],
                         ids=str)
def test_attention_kernel_matches_plain(cuda, shape, dtype):
    BH, S, hd, causal, window = shape
    B, H, K = gqa_split(BH)
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(B, S, n, hd).astype(np.float32))
               .cuda().to(dtype) for n in (H, K, K))
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, attention_plain(q, k, v, causal=causal, window=window),
           _tol("flash_attention", dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", ATTN_EDGES, ids=str)
def test_attention_edges_match_plain(cuda, shape, dtype):
    """The edges of the bf16 wgmma + TMA route: every head dim (each with
    its own TMA swizzle), S = 100 and 192, non-causal, a window that starts
    inside a key tile, and the training paths' shapes: 16/8 and 12/4 GQA at
    S 1024, hd 32 with a window of 16."""
    B, S, H, K, hd, causal, window = shape
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(B, S, n, hd).astype(np.float32))
               .cuda().to(dtype) for n in (H, K, K))
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    _close(out, attention_plain(q, k, v, causal=causal, window=window),
           _tol("flash_attention", dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", XENT_EDGES, ids=str)
def test_xent_edges_match_plain(cuda, shape, dtype):
    """The same for ``fused_xent``: a large tied head (the transposed view,
    a K-major operand), N = 96 and 384, d = 32 and 48, padded vocab, and
    the reduced architectures' and paper-moe's heads (d 256 and 768)."""
    N, d, Vp, V, tied = shape
    h, w, y = _xent_inputs(N, d, Vp, V, dtype)
    if tied:
        w = w.T.contiguous().T
    n0 = fused_xent.launches
    out = fused_xent(h, w, y, V)
    torch.cuda.synchronize()
    assert fused_xent.launches == n0 + 1
    _close(out, xent_plain(h, w, y, V), _tol("fused_xent", dtype))


@pytest.mark.cuda
def test_gradients_match_plain(cuda):
    """The autograd wrappers' backwards (torch, as in the JAX package)
    against autograd through the plain versions, in f32."""
    rng = np.random.RandomState(1)
    h = torch.from_numpy(rng.randn(2, 96, 64).astype(np.float32)).cuda()
    w = torch.from_numpy((rng.randn(64, 512) * 0.05).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 500, size=(2, 96)).astype(np.int32)).cuda()
    mask = torch.ones(2, 96, device="cuda")
    ins = [h.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    tot, _ = fused_xent_sum(ins[0], ins[1], y, mask, 500)
    got = torch.autograd.grad(tot, ins)
    ref_ins = [h.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    ref = xent_plain(ref_ins[0].reshape(-1, 64), ref_ins[1], y.reshape(-1), 500).sum()
    want = torch.autograd.grad(ref, ref_ins)
    for a, b in zip(got, want):
        _close(a, b, (1e-4, 1e-4 * float(b.abs().max())))
    q, k, v = (torch.from_numpy(rng.randn(2, 128, n, 32).astype(np.float32))
               .cuda().requires_grad_(True) for n in (4, 2, 2))
    r = torch.from_numpy(rng.randn(2, 128, 4, 32).astype(np.float32)).cuda()
    got = torch.autograd.grad((gqa_flash(q, k, v, window=48) * r).sum(), (q, k, v))
    want = torch.autograd.grad((attention_plain(q, k, v, window=48) * r).sum(),
                               (q, k, v))
    for a, b in zip(got, want):
        _close(a, b, _tol("flash_attention", torch.float32))


@pytest.mark.cuda
def test_bf16_kernels_refuse_unstaged_layouts(cuda):
    h, w, y = _xent_inputs(64, 32, 256, 256, torch.bfloat16)
    with pytest.raises(ValueError):
        fused_xent(h.T.contiguous().T, w, y, 256)
    q = torch.zeros(2, 64, 4, 16, dtype=torch.bfloat16, device="cuda")
    kv = torch.zeros(2, 64, 2, 20, dtype=torch.bfloat16, device="cuda")[..., :16]
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv)
    x = torch.zeros(2, 64, 4, 20, dtype=torch.bfloat16, device="cuda")[..., :16]
    bc = torch.zeros(2, 64, 1, 16, dtype=torch.bfloat16, device="cuda")
    dt = torch.full((2, 64, 4), 0.1, device="cuda")
    n0 = ssd_intra_chunk.launches
    with pytest.raises(ValueError):                  # head stride 20 elements
        ssd_intra_chunk(x, dt, -torch.ones(4, device="cuda"), bc, bc)
    assert ssd_intra_chunk.launches == n0


def _ssd_inputs(b, S, nh, hd, G, ds, dtype, seed=0, dt_shift=0.0):
    """x, B and C as views of one (b, S, nh·hd + 2·G·ds) tensor, the
    model's layout after the convolution; dt and A in f32."""
    rng = np.random.RandomState(seed)
    xBC = torch.from_numpy(rng.randn(b, S, nh * hd + 2 * G * ds)
                           .astype(np.float32)).cuda().to(dtype)
    dt = np.log1p(np.exp(rng.randn(b, S, nh) + dt_shift)).astype(np.float32)
    A = (-np.exp(rng.randn(nh) * 0.3)).astype(np.float32)
    di = nh * hd
    return (xBC[..., :di].reshape(b, S, nh, hd), torch.from_numpy(dt).cuda(),
            torch.from_numpy(A).cuda(),
            xBC[..., di:di + G * ds].reshape(b, S, G, ds),
            xBC[..., di + G * ds:].reshape(b, S, G, ds))


# (shape, dt_shift): the grid at dt = softplus(N(0, 1)), and chunks of 256
# at the model's init dt, where every 64-position tile of the chunk and its
# decay weigh above the tolerance (tests/test_torch_ssm.py shows why)
DT_INIT = math.log(math.expm1(0.01))
SSD_CASES = ([pytest.param(s, 0.0, id=str(s)) for s in
              SSD_SHAPES + [(1, 100, 2, 16, 1, 8, 32), (2, 128, 4, 32, 2, 16, 64)]]
             + [pytest.param(s, DT_INIT, id=f"{s}-init-dt") for s in
                [(2, 512, 4, 64, 1, 128, 256), (1, 256, 4, 64, 2, 128, 256)]])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,dt_shift", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, shape, dt_shift, dtype):
    b, S, nh, hd, G, ds, chunk = shape
    x, dt, A, B, C = _ssd_inputs(b, S, nh, hd, G, ds, dtype, dt_shift=dt_shift)
    cl = chunk_len(S, chunk)
    N = b * S // cl
    ins = (x.reshape(N, cl, nh, hd), dt.reshape(N, cl, nh), A,
           B.reshape(N, cl, G, ds), C.reshape(N, cl, G, ds))
    n0 = ssd_intra_chunk.launches
    out = ssd_intra_chunk(*ins)
    torch.cuda.synchronize()
    assert ssd_intra_chunk.launches == n0 + 1
    for o, r in zip(out, ssd_intra_chunk_plain(*ins)):
        assert o.dtype == torch.float32 and o.shape == r.shape
        _close(o, r, _tol("ssd_scan", dtype))
    y, state = ssd_chunked_kernel(x, dt, A, B, C, chunk=chunk)
    y_ref, state_ref = ssd_chunked(x, dt, A, B, C, chunk=chunk)
    _close(y, y_ref, _tol("ssd_scan", dtype))
    _close(state, state_ref, _tol("ssd_scan", dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("edge", SSD_EDGES, ids=str)
def test_ssd_edges_match_plain(cuda, edge, dtype):
    """The edges of the bf16 wgmma + TMA route (``numerics.SSD_EDGES``):
    every head dim, state sizes 8 to 128, chunks of 25 to 256, two groups,
    head slices of unequal size, the reduced Jamba/Mamba2 mixer (hd 16,
    chunk 16, ds 32) and the training shape at init dt."""
    *shape, init_dt = edge
    test_ssd_kernel_matches_plain(cuda, tuple(shape), DT_INIT if init_dt else 0.0,
                                  dtype)


@pytest.mark.cuda
def test_ssd_gradient_matches_plain(cuda):
    """``ssd_chunked_kernel``'s backward against autograd through the plain
    ``ssd_chunked``, in f32, on both outputs."""
    ins = _ssd_inputs(2, 128, 4, 32, 2, 16, torch.float32, seed=1,
                      dt_shift=-2.0)
    rng = np.random.RandomState(2)
    ry = torch.from_numpy(rng.randn(2, 128, 4, 32).astype(np.float32)).cuda()
    rs = torch.from_numpy(rng.randn(2, 4, 32, 16).astype(np.float32)).cuda()
    grads = []
    for fn in (ssd_chunked_kernel, ssd_chunked):
        t = [a.detach().clone().requires_grad_(True) for a in ins]
        y, s = fn(*t, chunk=64)
        grads.append(torch.autograd.grad((y * ry).sum() + (s * rs).sum(), t))
    rtol, atol = _tol("ssd_scan", torch.float32)
    for a, b in zip(*grads):
        _close(a, b, (rtol, atol * float(b.abs().max())))


@pytest.mark.cuda
def test_tiny_model_kernels_match_reference(cuda):
    """The tiny tier's loss and gradients through the kernels and through
    the model's plain paths, from one init, in f32."""
    _kernels_match_reference(zoo_config("transformer", "tiny"))


@pytest.mark.cuda
def test_tiny_ssm_kernels_match_reference(cuda):
    """The same for ``paper-ssm-tiny``: the SSD mixer through the
    ``ssd_scan`` kernel against the plain ``ssd_chunked``."""
    n0 = ssd_intra_chunk.launches
    _kernels_match_reference(zoo_config("ssm", "tiny"))
    assert ssd_intra_chunk.launches > n0


def _kernels_match_reference(cfg):
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32)).cuda()
    out = {}
    for kernels in ("cuda", "reference"):
        m = build_model(cfg, kernels=kernels, param_dtype=torch.float32)
        m.init(0)
        loss, _ = m.loss_fn({"tokens": tokens})
        out[kernels] = (loss, torch.autograd.grad(loss, m.params()))
    torch.testing.assert_close(out["cuda"][0], out["reference"][0],
                               rtol=1e-5, atol=0)
    for a, b in zip(out["cuda"][1], out["reference"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# the chunked engine: CUDA graph (IF nodes) against the eager per-step engine
# ---------------------------------------------------------------------------
def _tiny_zoo(model):
    from repro_torch.data import make_lm_tokens
    cfg = zoo_config(model, "tiny")
    m = build_model(cfg, kernels="cuda", param_dtype=torch.float32)
    data = make_lm_tokens(0, 8, 64, cfg.vocab_size)
    return m.init, m.loss_fn, m.params, data, 2, dict(k_sigma=-3.0, stop=3)


def _lenet8x8():
    from repro_torch.configs import CNNConfig, ConvSpec
    from repro_torch.data import make_classification
    from repro_torch.models import CNN, cnn_loss_fn, init_cnn
    cfg = CNNConfig(name="lenet-8x8", image_size=8, channels=1,
                    num_classes=10,
                    convs=(ConvSpec(4, 3, pool=2), ConvSpec(8, 3, pool=2)),
                    hidden=(24,))
    module = CNN(cfg)
    data = make_classification(0, 64, 8, 1, 10, noise=0.2, class_spread=3.0)
    return (lambda seed: init_cnn(module, seed),
            lambda b: cnn_loss_fn(module, b),
            lambda: list(module.parameters()), data, 8,
            dict(k_sigma=1.5, stop=3, zeta=0.02))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["transformer", "moe", "ssm", "lenet-8x8"])
def test_chunked_graph_matches_eager(cuda, model):
    """16 steps (K = 4) of the CUDA-graph engine against the eager
    per-step engine from the same init on the same card: the same
    accelerate and sub_iters sequences, losses within 1e-5 relative (f32),
    and Alg. 2 trips taken inside the graph."""
    from repro_torch.core import ISGDConfig, constant_lr
    from repro_torch.data import DeviceRing, FCPRSampler
    from repro_torch.optim import momentum
    from repro_torch.train import (TrainLog, make_chunked_train_step,
                                   make_train_step)
    init, loss_fn, params_of, data, bs, kw = (
        _lenet8x8() if model == "lenet-8x8" else _tiny_zoo(model))
    sampler = FCPRSampler(data, batch_size=bs, seed=1)
    icfg = ISGDConfig(n_batches=sampler.n_batches, **kw)
    lr_fn = constant_lr(0.03 if model == "lenet-8x8" else 0.005)
    steps, K = 16 if model != "lenet-8x8" else 32, 4

    init(0)
    params = params_of()
    sinit, step = make_train_step(loss_fn, momentum(0.9), icfg, lr_fn=lr_fn)
    state = sinit(params)
    ref = TrainLog()
    for j in range(steps):
        batch = {k: torch.from_numpy(v).cuda() for k, v in sampler(j).items()}
        state, params, m = step(state, params, batch)
        ref.append(m, 0.0)

    init(0)
    params = params_of()
    ring = DeviceRing(sampler.epoch_arrays(), bs)
    cinit, chunk = make_chunked_train_step(loss_fn, momentum(0.9), icfg,
                                           chunk_steps=K, lr_fn=lr_fn)
    cstate = cinit(params)
    got = TrainLog()
    for c in range(steps // K):
        cstate, params, ms = chunk(cstate, params, ring.arrays, c * K)
        got.extend(ms, 0.0)
    assert chunk.graph is not None
    assert got.accelerated == ref.accelerated
    assert got.sub_iters == ref.sub_iters
    assert sum(got.sub_iters) > 0, "no Alg. 2 trip ran"
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-5)
    assert int(cstate.sub_iters) == state.sub_iters


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["transformer", "moe", "ssm"])
def test_device_launch_counts_follow_graph_replays(cuda, model):
    """``launch_count`` counts a kernel at every replay of the fused
    engine's graph, and in an IF node only where the node's body runs: over
    16 fused steps each wrapper's device count equals the graph's
    evaluations times the per-evaluation count of the wrapper's host
    counter in the eager per-step engine. The steps of the queue's warm-up
    do not accelerate and later ones take Alg. 2 trips, so IF nodes both
    skip and fire."""
    from repro_torch.core import ISGDConfig, constant_lr
    from repro_torch.data import DeviceRing, FCPRSampler
    from repro_torch.kernels import launch_count
    from repro_torch.optim import momentum
    from repro_torch.train import make_chunked_train_step, make_train_step
    wrappers = {"fused_xent": fused_xent, "flash_attention": flash_attention,
                "ssd_scan": ssd_intra_chunk}
    init, loss_fn, params_of, data, bs, kw = _tiny_zoo(model)
    sampler = FCPRSampler(data, batch_size=bs, seed=1)
    icfg = ISGDConfig(n_batches=sampler.n_batches, **kw)
    lr_fn, steps, K = constant_lr(0.005), 16, 4

    init(0)
    params = params_of()
    sinit, step = make_train_step(loss_fn, momentum(0.9), icfg, lr_fn=lr_fn)
    state = sinit(params)
    host0 = {n: w.launches for n, w in wrappers.items()}
    for j in range(steps):
        batch = {k: torch.from_numpy(v).cuda() for k, v in sampler(j).items()}
        state, params, _ = step(state, params, batch)
    evals = steps + state.sub_iters
    per_eval = {n: (w.launches - host0[n]) // evals
                for n, w in wrappers.items()}
    assert all(per_eval[n] * evals == wrappers[n].launches - host0[n]
               for n in wrappers)
    assert per_eval["fused_xent"] == 1

    init(0)
    params = params_of()
    ring = DeviceRing(sampler.epoch_arrays(), bs)
    launch_count.enable("cuda", wrappers)
    try:
        cinit, chunk = make_chunked_train_step(loss_fn, momentum(0.9), icfg,
                                               chunk_steps=K, lr_fn=lr_fn)
        cstate = cinit(params)
        chunk.prepare(cstate, params, ring.arrays)
        launch_count.reset()
        for c in range(steps // K):
            cstate, params, _ = chunk(cstate, params, ring.arrays, c * K)
        got = launch_count.read()
    finally:
        launch_count.disable()
    gevals = steps + int(cstate.sub_iters)
    assert int(cstate.sub_iters) > 0, "no Alg. 2 trip ran"
    assert got == {n: per_eval[n] * gevals for n in wrappers}


@pytest.mark.cuda
@pytest.mark.parametrize("missing", ["cuda-12.2", "pool-routing"])
def test_chunked_raises_without_conditional_nodes(cuda, monkeypatch, missing):
    """On CUDA params the fused engine refuses to start where CUDA-graph
    IF nodes cannot be captured; it never falls back to host reads."""
    from repro_torch.core import ISGDConfig, constant_lr
    from repro_torch.optim import momentum
    from repro_torch.train import make_chunked_train_step

    params = [torch.zeros(4, device="cuda", requires_grad=True)]
    init_fn, _ = make_chunked_train_step(
        lambda b: (params[0].sum(),) * 2, momentum(0.9),
        ISGDConfig(n_batches=2), chunk_steps=2, lr_fn=constant_lr(0.1))
    if missing == "cuda-12.2":
        monkeypatch.setattr(torch.version, "cuda", "12.2")
    else:
        monkeypatch.delattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool")
    with pytest.raises(RuntimeError, match="conditional nodes"):
        init_fn(params)


@pytest.mark.cuda
def test_if_node_runs_body_where_pred_holds(cuda, monkeypatch):
    """An IF node around a loss-and-gradient: the body recorded while the
    step runs eagerly, spliced while it is captured; replayed with the
    predicate false the graph leaves the output alone, true it adds the
    eager gradient. A convolution of alexnet-small's first layer at batch
    256 is in the body (cuDNN's multi-engine convolutions), with cuDNN's
    deterministic algorithms, so that the graph and the eager run sum in
    one order."""
    import torch.nn.functional as F

    from repro_torch.core import run_if
    from repro_torch.kernels.graph_if import IfBodies, require
    require()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.manual_seed(0)
    w = torch.randn(64, 3, 11, 11, device="cuda", requires_grad=True)
    x = torch.randn(256, 3, 71, 71, device="cuda")
    pred = torch.zeros((), dtype=torch.bool, device="cuda")
    out = torch.zeros_like(w)

    def body():
        y = F.conv2d(x, w, stride=4)
        (g,) = torch.autograd.grad(torch.tanh(y).square().sum(), [w])
        out.add_(g)

    def step():
        out.mul_(1.0)
        run_if(pred, body)

    body()                                   # eager: the reference
    torch.cuda.synchronize()
    ref = out.clone()
    out.zero_()
    bodies = IfBodies("cuda")
    with bodies.recording():
        step()
    assert bodies.recorded == 1 and not out.any()
    graph = torch.cuda.CUDAGraph()
    with bodies.splicing(), torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize()
    assert not out.any()
    pred.fill_(True)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, 2 * ref, rtol=1e-6,
                               atol=1e-6 * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# telemetry and micro-batches on the card (CPU twins: test_torch_obs.py,
# test_torch_trainer.py)
# ---------------------------------------------------------------------------
def _observed_run(model, engine, micro_batches=1, steps=16, profiler=None):
    """A tiny run on the card with a ``TrainObserver`` at the engine's own
    boundaries: per-step through ``train``, fused (K = 4) through chunks
    whose one host read ``obs.chunk`` ingests. ``profiler``, if given, is
    entered around the capture and the chunks. -> (observer, state, log,
    device launch counts of the fused run)."""
    import contextlib

    from repro_torch.core import ISGDConfig, constant_lr
    from repro_torch.data import DeviceRing, FCPRSampler
    from repro_torch.kernels import launch_count
    from repro_torch.obs import MemorySink, MetricsRecorder, TrainObserver
    from repro_torch.optim import momentum
    from repro_torch.train import (TrainLog, make_chunked_train_step,
                                   make_step_core, train)
    init, loss_fn, params_of, data, bs, kw = (
        _lenet8x8() if model == "lenet-8x8" else _tiny_zoo(model))
    sampler = FCPRSampler(data, batch_size=bs, seed=1)
    icfg = ISGDConfig(n_batches=sampler.n_batches, **kw)
    lr_fn = constant_lr(0.03 if model == "lenet-8x8" else 0.005)
    if model == "lenet-8x8":
        steps = 32
    init(0)
    params = params_of()
    obs = TrainObserver(MetricsRecorder([MemorySink()],
                                        tags={"process_id": 0}),
                        n_batches=icfg.n_batches, k_sigma=icfg.k_sigma)
    counts = None
    if engine == "per-step":
        if micro_batches == 1:
            _, state, log, _ = train(params, loss_fn, momentum(0.9), sampler,
                                     steps=steps, isgd_cfg=icfg, lr_fn=lr_fn,
                                     observer=obs, step_sync=True)
        else:
            sinit, step = make_step_core(loss_fn, momentum(0.9), icfg,
                                         lr_fn=lr_fn,
                                         micro_batches=micro_batches)
            state, log = sinit(params), TrainLog()
            for j in range(steps):
                batch = {k: torch.from_numpy(v).cuda()
                         for k, v in sampler(j).items()}
                state, params, m = step(state, params, batch)
                log.append(m, 0.0)
        return obs, state, log, counts
    ring = DeviceRing(sampler.epoch_arrays(), bs)
    wrappers = {"fused_xent": fused_xent, "flash_attention": flash_attention,
                "ssd_scan": ssd_intra_chunk}
    launch_count.enable("cuda", wrappers)
    try:
        with profiler if profiler is not None else contextlib.nullcontext():
            cinit, chunk = make_chunked_train_step(
                loss_fn, momentum(0.9), icfg, chunk_steps=4, lr_fn=lr_fn,
                micro_batches=micro_batches)
            state = cinit(params)
            chunk.prepare(state, params, ring.arrays)
            launch_count.reset()
            log = TrainLog()
            for c in range(steps // 4):
                state, params, ms = chunk(state, params, ring.arrays, c * 4)
                obs.chunk(c * 4, log.extend(ms, 0.0))
        counts = launch_count.read()
    finally:
        launch_count.disable()
    assert chunk.graph is not None
    return obs, state, log, counts


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["per-step", "fused"])
@pytest.mark.parametrize("model", ["transformer", "lenet-8x8"])
def test_spc_reconciles_on_card(cuda, model, engine):
    """The host mirror of the SPC queue against the queue on the card, bit
    for bit, after runs that fire the accelerate branch (inside the graph's
    IF nodes for the fused engine)."""
    obs, state, log, _ = _observed_run(model, engine)
    final = obs.finalize(state, steps=len(log.losses), wall=1.0)
    assert final["reconciled"], final["mismatches"]
    assert final["accel_count"] == sum(log.accelerated) > 0
    assert final["sub_iters"] == sum(log.sub_iters) > 0
    if engine == "per-step":
        assert log.wall_est == [False] * len(log.losses)


@pytest.mark.cuda
def test_fused_micro_batches_match_eager_on_card(cuda):
    """``micro_batches=2``: the micro-batch loop and its f32 gradient sums
    captured into the graph (the trips' too) against the eager per-step
    engine: the same decisions, losses within 1e-5 relative (f32)."""
    _, ref_state, ref, _ = _observed_run("transformer", "per-step",
                                         micro_batches=2)
    _, state, got, _ = _observed_run("transformer", "fused", micro_batches=2)
    assert got.accelerated == ref.accelerated and sum(got.sub_iters) > 0
    assert got.sub_iters == ref.sub_iters
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-5)
    assert int(state.sub_iters) == ref_state.sub_iters


@pytest.mark.cuda
def test_spans_in_capture_add_no_launch(cuda):
    """With a profiler running through the warm-up and the capture, the
    ``obs/psi_push`` and ``obs/accelerate`` spans are live while the step
    and its IF bodies are captured: the capture still succeeds, and the
    graph launches each kernel as often as the same run without the
    profiler (device counts), with the same trajectory."""
    from torch.profiler import ProfilerActivity, profile
    _, _, plain, plain_counts = _observed_run("transformer", "fused")
    prof = profile(activities=[ProfilerActivity.CPU])
    _, _, spanned, counts = _observed_run("transformer", "fused",
                                          profiler=prof)
    names = {e.key for e in prof.key_averages()}
    assert {"obs/psi_push", "obs/accelerate", "obs/chunk_scan"} <= names
    assert counts == plain_counts and counts["fused_xent"] > 0
    assert spanned.losses == plain.losses
    assert spanned.sub_iters == plain.sub_iters and sum(plain.sub_iters) > 0


# ---------------------------------------------------------------------------
# the MoE layer and the reduced architectures on the card
# ---------------------------------------------------------------------------
def _moe_inputs(dtype=torch.bfloat16, B=4, S=256, seed=0):
    """``paper-moe``'s MoE layer (d 768, 8 experts top-2, ff 1536, cf 1.25,
    so that slots are dropped) with two shared experts added, weights drawn
    as the model's init draws them, and x (B, S, d)."""
    import dataclasses

    from repro_torch.models.moe import init_moe
    cfg = dataclasses.replace(zoo_config("moe", "base"), num_shared_experts=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = {}
    for k, w in init_moe(cfg, dtype, "cuda").items():
        r = torch.randn(w.shape, generator=gen, device="cuda")
        p[k] = (r / math.sqrt(w.shape[-2])).to(w.dtype).requires_grad_(True)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    return cfg, p, x.to(dtype)


@pytest.mark.cuda
def test_moe_forward_has_no_host_sync(cuda):
    """``moe_forward`` and its backward read nothing back to the host, so
    the fused engine can capture them: with sync debug mode at "error", any
    synchronising call raises."""
    from repro_torch.models.moe import moe_forward
    cfg, p, x = _moe_inputs()
    y, aux = moe_forward(p, cfg, x)                      # warm-up, lazy init
    torch.autograd.grad((y.float().sum() + aux), list(p.values()))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe_forward(p, cfg, x)
        grads = torch.autograd.grad((y.float().sum() + aux), list(p.values()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
def test_moe_forward_graph_replay_is_bit_exact(cuda):
    """A CUDA graph of ``moe_forward`` (routing, dispatch, expert products,
    combine, aux), replayed, equals the eager run bit for bit."""
    from repro_torch.models.moe import moe_forward
    cfg, p, x = _moe_inputs()
    p = {k: v.detach() for k, v in p.items()}
    with torch.no_grad():
        ref_y, ref_aux = moe_forward(p, cfg, x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe_forward(p, cfg, x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y, aux = moe_forward(p, cfg, x)
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(y, ref_y) and torch.equal(aux, ref_aux)


@pytest.mark.cuda
def test_reduced_jamba_runs_ssd_kernel(cuda):
    """Reduced Jamba (7 of 8 layers SSM, hd 16, chunk 16, d_state 32) in
    bf16: one loss through the kernels launches ``ssd_scan`` twice per SSM
    layer (forward and the recomputation) and ``flash_attention`` twice for
    its attention layer, and stays within the bf16 tolerances of the plain
    run from the same init: the loss within ``fused_xent``'s, layer 0's
    mixer output within ``ssd_scan``'s."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import ssm_forward
    cfg = get_config("jamba_v0_1_52b").reduced()
    assert (cfg.ssm_headdim, cfg.ssm_chunk, cfg.ssm_state) == (16, 16, 32)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32)).cuda()
    loss = {}
    for kernels in ("cuda", "reference"):
        m = build_model(cfg, kernels=kernels, param_dtype=torch.bfloat16)
        m.init(0)
        n0 = (ssd_intra_chunk.launches, flash_attention.launches)
        total, _ = m.loss_fn({"tokens": tokens})
        torch.autograd.grad(total, m.params())
        loss[kernels] = float(total.detach())
        if kernels == "cuda":
            assert ssd_intra_chunk.launches - n0[0] == 2 * 7
            assert flash_attention.launches - n0[1] == 2 * 1
            h = torch.from_numpy(np.random.RandomState(2).randn(
                2, 64, cfg.d_model).astype(np.float32)).cuda().bfloat16()
            p = m.module.layers[0].mixer
            with torch.no_grad():
                _close(ssm_forward(p, cfg, h, use_kernel=True),
                       ssm_forward(p, cfg, h, use_kernel=False),
                       _tol("ssd_scan", torch.bfloat16))
    rtol = _tol("fused_xent", torch.bfloat16)[0]
    assert abs(loss["cuda"] - loss["reference"]) <= rtol * abs(loss["reference"])


@pytest.mark.cuda
def test_sched_parity_on_card(cuda):
    """The scheduled engines on the card: fcpr bit-exact with the
    unscheduled ones, loss-prop per-step equal to fused (its draw, table
    update and gather inside the CUDA graph), one chunk call per K steps."""
    from repro_torch.sched import run_sched_parity
    r = run_sched_parity(device="cuda")
    assert r["ok"] and r["accelerations"] > 0, r


@pytest.mark.cuda
def test_resume_parity_on_card(cuda):
    """Kill and resume on the card, bit for bit: the restore copies into
    the tensors a captured graph holds, so the graph trains them."""
    from repro_torch.train.resume_parity import run_resume_parity
    for r in run_resume_parity(device="cuda"):
        assert r["ok"] and r["max_dev"] == 0.0, r
        assert r["accelerations"] > 0, r


@pytest.mark.cuda
def test_hybrid_and_multihost_parity_on_card(cuda):
    """The hybrid parity matrix over two gloo ranks sharing the card (its
    fused legs need NCCL and are left out) and over one NCCL rank (the
    fused legs captured), and the pod mesh against the flat one over four
    gloo ranks, as ``chip_smoke.py``'s phases run them."""
    from repro_torch.distributed.hybrid_parity import run_hybrid_parity_ranks
    from repro_torch.distributed.multihost_parity import run_multihost_parity
    r = run_hybrid_parity_ranks(2, device="cuda", backend="gloo",
                                timeout=300)
    assert r["ok"] and r["ranks_agree"] and r["accelerations"] > 0, r
    assert len(r["omitted"]) == 4
    assert r["legs"]["sharded-tp(model=2)"]["max_param"] <= 1e-5
    r = run_hybrid_parity_ranks(1, device="cuda", backend="nccl",
                                timeout=300)
    assert r["ok"] and not r["omitted"], r
    r = run_multihost_parity(procs=4, pods=2, device="cuda", backend="gloo",
                             timeout=300)
    assert r["ok"] and r["omitted"] == ["chunked", "sched"], r


@pytest.mark.cuda
def test_nccl_reduce_scatter_across_cards_equals_the_gathered_mean(cuda):
    """``AxisReduce``'s reduce-scatter over NCCL, one card a rank (up to
    four): every rank's part of the whole, sliced and (at four) pod
    layouts equals that part of the rank-order ``shard_mean`` of every
    rank's leaf bit for bit, as over gloo on the CPU; the sliced layout
    captured in a CUDA graph and replayed on twice the shards gives twice
    the means, bit for bit (a power of two scales exactly)."""
    import _torch_dist_workers as W
    from repro_torch.core.reduce import shard_mean
    from repro_torch.launch.env import spawn_ranks
    world = min(4, torch.cuda.device_count())
    if world < 2:
        pytest.skip("needs two cards: NCCL refuses two ranks on one")
    ranks = spawn_ranks(W.nccl_scatter_rank, world, 7, device="cuda",
                        timeout=300)
    s = W._scatter_shards(world, 7)
    bf16 = torch.bfloat16

    def mean(key, dtype=torch.float32, scale=1.0):
        t = (torch.from_numpy(s[key]) * scale).to(dtype).float()
        return shard_mean(t).to(dtype).float().numpy()
    whole = [mean("x"), mean("y", bf16), mean("z")]
    for r, got in enumerate(ranks):
        for a, b in zip(got["whole"][0], whole):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} whole")
        layouts = [k for k in got if k not in ("whole", "captured")]
        assert layouts == (["sliced", "pods"] if world == 4 else ["sliced"])
        for name, scale in [(k, 1.0) for k in layouts] + [("captured", 2.0)]:
            full = [mean("u", scale=scale), mean("v", bf16, scale),
                    mean("y", scale=scale), mean("w", scale=scale)]
            means = got[name] if name == "captured" else got[name][0]
            parts = got["sliced"][2] if name == "captured" else got[name][2]
            for i, (a, f) in enumerate(zip(means, full)):
                box = (tuple(slice(0, n) for n in f.shape) if parts[i] is None
                       else tuple(slice(x, y) for x, y in parts[i][1]))
                np.testing.assert_array_equal(a, f[box],
                                              err_msg=f"rank {r} {name} {i}")


@pytest.mark.cuda
def test_data_parallel_parity_on_card(cuda):
    """The data-parallel engine on one NCCL rank against the single-device
    engine on the reference's least-squares rig: the one-rank gather and
    mean leave every value as it was, so the two agree bit for bit; then
    the fused data-parallel engine (its collectives inside the CUDA graph
    and its IF nodes) against the per-step one, bit for bit, with the
    branch firing."""
    from repro_torch.distributed import (make_chunked_data_parallel_step,
                                         make_data_parallel_step)
    from repro_torch.distributed.parity import problem, run_parity
    from repro_torch.core import constant_lr
    from repro_torch.data import DeviceRing
    from repro_torch.launch import env
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.optim import momentum
    r = run_parity(device="cuda")
    assert r["ok"] and r["accelerations"] > 0, r
    assert r["max_param"] == r["max_psi_bar"] == r["max_limit"] == 0.0
    make, sampler, icfg = problem(cuda)
    lr_fn = constant_lr(0.01)
    with env.local_group(cuda):
        mesh = make_data_mesh("cuda")
        ring = DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                          mesh=mesh)
        p1, lf = make()
        init, step = make_data_parallel_step(lf, momentum(0.9), icfg, mesh,
                                             lr_fn=lr_fn)
        s1, losses, accel = init(p1), [], 0
        for j in range(16):
            s1, p1, m = step(s1, p1, ring(j))
            losses.append(float(m["loss"]))
            accel += int(m["accelerated"])
        p2, lf = make()
        init, chunk = make_chunked_data_parallel_step(
            lf, momentum(0.9), icfg, mesh, chunk_steps=4, lr_fn=lr_fn)
        s2, fused = init(p2), []
        for c in range(4):
            s2, p2, ms = chunk(s2, p2, ring.arrays, 4 * c)
            fused += ms["loss"].tolist()
    assert accel > 0 and fused == losses
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


# ---------------------------------------------------------------------------
# serving: the slot engine's decode graph
# ---------------------------------------------------------------------------
def _slot_engine(cuda, name, max_seq=64):
    from repro_torch.configs import get_config
    from repro_torch.serve import SlotKV
    cfg = (zoo_config(name, "tiny") if name in ("transformer", "moe", "ssm")
           else get_config(name).reduced())
    m = build_model(cfg, kernels="cuda", param_dtype=torch.bfloat16,
                    device=cuda)
    m.init(0, max_seq=max_seq)
    kv = SlotKV(m, max_batch=4, max_seq=max_seq)
    rng = np.random.RandomState(0)
    for slot, n in enumerate((5, 9, 7)):
        kv.admit(slot, rng.randint(0, cfg.vocab_size, size=n).astype(np.int32))
    return cfg, m, kv


def _replay_equals_eager(kv):
    """One decode from the same slot state, replayed and eager: tokens,
    logits, cursors and every cache entry equal bit for bit."""
    saved = [t.clone() for t in kv.tensors()]
    graph_tok = kv.decode()
    after = [t.clone() for t in kv.tensors()]
    for t, s in zip(kv.tensors(), saved):
        t.copy_(s)
    eager_tok = kv.decode(eager=True)
    assert np.array_equal(graph_tok, eager_tok)
    assert all(torch.equal(a, b) for a, b in zip(kv.tensors(), after))
    return graph_tok


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["transformer", "moe", "ssm",
                                  "deepseek_v2_lite_16b"])
def test_decode_graph_replays_eager_bit_for_bit(cuda, name):
    """The first decode runs eagerly and captures the step; every later
    decode replays it, across admits and retires, bit for bit with the
    eager step on the same state; one capture for the engine's life."""
    cfg, m, kv = _slot_engine(cuda, name)
    kv.decode()
    assert kv.compile_counts()["decode"] == 1
    for i in range(3):
        _replay_equals_eager(kv)
        if i == 0:
            kv.retire(1)
            kv.admit(3, np.arange(6, dtype=np.int32))
    assert kv.compile_counts()["decode"] == 1


@pytest.mark.cuda
def test_swap_params_reaches_the_graph(cuda):
    """``swap_params`` copies into the live parameters: a replay after the
    swap equals an eager decode with the new weights, and differs from the
    replay with the old ones."""
    cfg, m, kv = _slot_engine(cuda, "transformer")
    kv.decode()                                     # eager + capture
    other = build_model(cfg, kernels="cuda", param_dtype=torch.bfloat16,
                        device=cuda)
    other.init(7, max_seq=64)
    saved = [t.clone() for t in kv.tensors()]
    old = kv.decode()
    old_logits = kv.logits.clone()
    for t, s in zip(kv.tensors(), saved):
        t.copy_(s)
    kv.swap_params(other.params())
    new = _replay_equals_eager(kv)
    assert not torch.equal(kv.logits, old_logits)
    assert new.shape == old.shape
    assert kv.compile_counts()["decode"] == 1
