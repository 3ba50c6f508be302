"""Port vs JAX: the analysis tier (``repro_torch.analysis``, the input-shape
tables, ``Model.input_specs`` and ``repro_torch.launch.dryrun``), on the
CPU.

  * the input-shape table, ``LONG_CONTEXT_ARCHS`` and ``shape_applicable``,
    ``input_specs`` and ``model_flops`` equal the reference's exactly, for
    every architecture and shape (and 1, 256 and 512 chips);
  * the collective byte model equals the reference's HLO parser
    (``collective_stats``) on HLO lines of the five kinds, with and without
    ``-start``/``-done``;
  * the analysis-mode ISGD step (every Alg. 2 trip run, masked) is the
    normal device step bit for bit, and follows the reference's
    analysis-mode ``isgd_step`` within the trajectory tolerance of
    ``tests/test_torch_isgd.py`` (1e-5 relative), with exactly 1 + stop
    evaluations a step;
  * the meta-device FLOP count of a reduced evaluation, elementwise work
    counted XLA's way, is within ±3 % of XLA's ``cost_analysis()`` of the
    reference's in analysis mode (mamba2 against the compiled program:
    ±3.5 %, ``XLA_COMPILED_TOL``), and its aten FLOPs equal
    ``FlopCounterMode``'s on the CPU exactly;
  * the two-point extrapolation over layer blocks equals the full-depth
    count exactly, for every family, under the 256-rank fake mesh; a
    reduced arch runs under the 256- and 512-rank fake meshes with its
    argument bytes and its data and model all-gathers;
  * each kernel wrapper's meta branch records exactly its ``cost()``, and
    the ``cost()`` values at the main shapes are the formulas
    ``chip_smoke.py`` inlined before;
  * the serving shapes, ``--cache-shard batch`` and ``--remat-policy
    tp_out`` raise and name slice A17b; ``--all`` lists them as SKIP.

The fake process group lives in this process; a fixture destroys it after
each test that made one.
"""
import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import roofline as JR
from repro.analysis.mode import analysis_mode as j_analysis_mode
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import zoo_config as j_zoo_config
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import LONG_CONTEXT_ARCHS as J_LONG
from repro.configs.base import shape_applicable as j_applicable
from repro.core import ISGDConfig as J_ISGDConfig
from repro.core.schedule import constant_lr as j_constant_lr
from repro.data.fcpr import FCPRSampler as JFCPR
from repro.models import build_model as j_build_model
from repro.models import transformer as JT
from repro.optim import momentum as j_momentum
from repro.train import make_train_step as j_make_train_step
from repro.train.trainer import make_loss_and_grad as j_make_loss_and_grad
from repro_torch.analysis import analysis_mode, roofline
from repro_torch.analysis import count as C
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, LONG_CONTEXT_ARCHS,
                                 InputShape, get_config, shape_applicable,
                                 zoo_config)
from repro_torch.convert import params_from_jax
from repro_torch.core import ISGDConfig, constant_lr
from repro_torch.data import FCPRSampler, make_lm_tokens
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshError, make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim import momentum
from repro_torch.train.chunked import make_device_step
from repro_torch.train.trainer import make_loss_and_grad

torch.set_num_threads(2)
SMALL = InputShape("small", 64, 2, "train")      # B 2, S 64
MESH_SMALL = InputShape("small16", 64, 16, "train")   # a row a data rank
FAMILIES = {"dense": "internlm2_1_8b", "moe": "deepseek_v2_lite_16b",
            "ssm": "mamba2_2_7b", "hybrid": "jamba_v0_1_52b",
            "encdec": "whisper_medium", "vlm": "internvl2_2b"}


@pytest.fixture
def fake_world():
    """Destroy the fake group a test made (``make_production_mesh``)."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tables: input shapes, input_specs, model_flops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_shape_table_matches_jax(arch):
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for name, s in INPUT_SHAPES.items():
        j = J_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
    assert LONG_CONTEXT_ARCHS == J_LONG
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in INPUT_SHAPES:
        assert shape_applicable(cfg, INPUT_SHAPES[name]) == \
            j_applicable(jcfg, J_SHAPES[name])


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch, shape):
    want = j_build_model(j_get_config(arch)).input_specs(J_SHAPES[shape])
    got = build_model(get_config(arch), device="meta").input_specs(
        INPUT_SHAPES[shape])
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).removeprefix("torch.") == str(np.dtype(want[k].dtype))


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(arch, shape):
    for chips in (1, 256, 512):
        assert roofline.model_flops(get_config(arch), INPUT_SHAPES[shape],
                                    chips) == \
            JR.model_flops(j_get_config(arch), J_SHAPES[shape], chips)


# ---------------------------------------------------------------------------
# the collective byte model against the reference's HLO parser
# ---------------------------------------------------------------------------
_HLO_DTYPES = {"bf16": 2, "f32": 4}


def _hlo_shape(dt, dims):
    return f"{dt}[{','.join(map(str, dims))}]{{{','.join(map(str, range(len(dims) - 1, -1, -1)))}}}"


def _bytes(dt, dims):
    return _HLO_DTYPES[dt] * int(np.prod(dims))


@pytest.mark.parametrize("asynchronous", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("kind", C.COLLECTIVE_KINDS)
def test_collective_bytes_match_hlo_parser(kind, asynchronous):
    """One collective rendered as post-SPMD HLO (a ``-start``/``-done``
    pair, whose start returns the (operand, result) tuple, where
    asynchronous): the reference's parser and the port's record of the same
    result and operand bytes count the same traffic, once."""
    rng = np.random.RandomState(C.COLLECTIVE_KINDS.index(kind) + 10 * asynchronous)
    dt = ["bf16", "f32"][rng.randint(2)]
    n, rows, cols = int(rng.randint(2, 17)), int(rng.randint(1, 64)), int(rng.randint(1, 512))
    operand = (rows * n, cols) if kind == "reduce-scatter" else (rows, cols)
    result = {"all-gather": (rows * n, cols),
              "reduce-scatter": (rows, cols)}.get(kind, operand)
    op_s, res_s = _hlo_shape(dt, operand), _hlo_shape(dt, result)
    if asynchronous:
        sig = f"({op_s}, {res_s})"
        text = (f"  %c-start = {sig} {kind}-start({op_s} %p), channel_id=1\n"
                f"  %c-done = {res_s} {kind}-done({sig} %c-start)\n")
        result_bytes = _bytes(dt, operand) + _bytes(dt, result)
    else:
        text = f"  %c = {res_s} {kind}({op_s} %p), channel_id=1\n"
        result_bytes = _bytes(dt, result)
    want = JR.collective_stats(text)
    with analysis_mode(), C.CostCount() as cc:
        C.collective(kind, result_bytes, _bytes(dt, operand), (0, 1))
    got = cc.count.collective_stats()
    assert got == want
    assert got[kind]["count"] == 1 and got[kind]["bytes"] > 0


def test_collectives_record_only_in_analysis_mode():
    with C.CostCount() as cc:
        C.collective("all-gather", 64, 4, (0, 1))
    with analysis_mode(), C.CostCount() as cc1:
        C.collective("all-gather", 64, 4, (0,))          # one rank: no link
    assert cc.count.collectives == [] and cc1.count.collectives == []


# ---------------------------------------------------------------------------
# the analysis-mode ISGD step
# ---------------------------------------------------------------------------
STEPS, BATCH, LR, STOP = 12, 2, 0.005, 3


def _port_run(tree, data, analysis, k_sigma, zeta):
    cfg = zoo_config("transformer", "tiny")
    tm = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                     device="cpu")
    tm.module.load_state_dict(params_from_jax(tree, cfg))
    evals = []

    def loss_fn(batch):
        evals[-1] += 1
        return tm.loss_fn(batch)

    init_fn, step_fn = make_device_step(
        loss_fn, momentum(), ISGDConfig(n_batches=4, k_sigma=k_sigma,
                                        stop=STOP, zeta=zeta),
        lr_fn=constant_lr(LR))
    params = tm.params()
    state = init_fn(params)
    samp = FCPRSampler(data, batch_size=BATCH, seed=1)
    out = []
    for j in range(STEPS):
        evals.append(0)
        batch = {"tokens": torch.from_numpy(samp(j)["tokens"])}
        with analysis_mode(analysis):
            state, params, m = step_fn(state, params, batch)
        out.append({k: v.clone() for k, v in m.items()})
    return out, [p.detach().clone() for p in params], state, evals


def _jax_run(jp, data, k_sigma, zeta):
    jm = j_build_model(j_zoo_config("transformer", "tiny"),
                       kernels="reference", param_dtype=jnp.float32)
    jinit, jstep = j_make_train_step(
        jm.loss_fn, j_momentum(),
        J_ISGDConfig(n_batches=4, k_sigma=k_sigma, stop=STOP, zeta=zeta),
        lr_fn=j_constant_lr(LR))
    params = dict(jp, blocks=list(jp["blocks"]))
    state = jinit(params)
    samp = JFCPR(data, batch_size=BATCH, seed=1)
    out = []
    with j_analysis_mode():
        for j in range(STEPS):
            state, params, m = jstep(state, params, samp(j))
            out.append((float(m["loss"]), bool(m["accelerated"]),
                        int(m["sub_iters"])))
    return out


@pytest.mark.parametrize("k_sigma,seed,zeta", [(1.0, 2, 1.0), (-3.0, 0, None)],
                         ids=["k1", "every-step"])
def test_analysis_mode_step_is_the_normal_step(k_sigma, seed, zeta):
    """Analysis mode runs the accelerate branch and all ``stop`` trips of
    every step (1 + stop evaluations), and masks what the normal step would
    not have run, so its metrics and params are the normal step's bit for
    bit; the reference in its analysis mode makes the same decisions."""
    cfg = zoo_config("transformer", "tiny")
    data = make_lm_tokens(0, 4 * BATCH, 64, cfg.vocab_size)
    jp = JT.init_params(jax.random.PRNGKey(seed),
                        j_zoo_config("transformer", "tiny"), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    ref, ref_p, ref_s, ref_evals = _port_run(tree, data, False, k_sigma, zeta)
    got, got_p, got_s, got_evals = _port_run(tree, data, True, k_sigma, zeta)
    for r, g in zip(ref, got):
        for k in r:
            assert torch.equal(r[k], g[k]), k
    for a, b in zip(ref_p, got_p):
        assert torch.equal(a, b)
    for k in ("iter", "accel_count", "sub_iters"):
        assert torch.equal(getattr(ref_s, k), getattr(got_s, k))
    assert got_evals == [1 + STOP] * STEPS
    assert ref_evals == [1 + int(m["sub_iters"]) for m in ref]
    fired = [bool(m["accelerated"]) for m in ref]
    assert any(fired) and not all(fired)          # both branches seen
    if k_sigma > 0:                               # a trip cut short, masked
        assert any(0 < int(m["sub_iters"]) < STOP for m in ref) or \
            any(not f for f in fired[4:])
    jref = _jax_run(jp, data, k_sigma, zeta)
    assert [(bool(m["accelerated"]), int(m["sub_iters"])) for m in got] == \
        [r[1:] for r in jref]
    np.testing.assert_allclose([float(m["loss"]) for m in got],
                               [r[0] for r in jref], rtol=1e-5)


# ---------------------------------------------------------------------------
# the meta FLOP count against XLA's and FlopCounterMode's
# ---------------------------------------------------------------------------
def _cost_flops(cost) -> float:
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


def _xla_flops(arch):
    """XLA's ``cost_analysis()`` FLOPs of the reference's reduced
    evaluation in analysis mode: (compiled, lowered), the program after and
    before XLA's passes."""
    jcfg = j_get_config(arch).reduced()
    jm = j_build_model(jcfg, kernels="reference", param_dtype=jnp.float32)
    params = jax.eval_shape(lambda k: jm.init(k, max_seq=SMALL.seq_len),
                            jax.random.PRNGKey(0))
    specs = jm.input_specs(JInputShape("small", SMALL.seq_len,
                                       SMALL.global_batch, "train"))
    lg = j_make_loss_and_grad(jm.loss_fn)
    with j_analysis_mode():
        lowered = jax.jit(lg).lower(params, specs)
        compiled = lowered.compile()
    return (_cost_flops(compiled.cost_analysis()),
            _cost_flops(lowered.cost_analysis()))


def _meta_evaluation(cfg, kernels="reference", device="meta",
                     dtype=torch.float32):
    model = build_model(cfg, kernels=kernels, param_dtype=dtype,
                        device=device)
    model.init(0, max_seq=SMALL.seq_len)
    batch = model.input_specs(SMALL)
    if device != "meta":
        rng = np.random.RandomState(0)
        batch = {k: torch.from_numpy(
            rng.randint(0, cfg.vocab_size, v.shape).astype(np.int32)
            if k == "tokens" else rng.randn(*v.shape).astype(np.float32)
        ).to(v.dtype) for k, v in batch.items()}
    lg = make_loss_and_grad(model.loss_fn)
    return lambda: lg(model.params(), batch)


# The compiled program counts an elementwise op once for every fusion XLA
# copies it into. mamba2's reduced SSM layers (d 256, head 16, state 32,
# chunk 16) do much elementwise work beside small products, and the
# compiled count reads 0.968 of the port's; its products equal the dot
# FLOPs of the compiled HLO within 0.05 % and the program before XLA's
# passes agrees to 0.997. So against the compiled count mamba2's band is
# ±3.5 %, the ±3 % criterion unmet there (PERF.md, open questions).
XLA_COMPILED_TOL = {"mamba2_2_7b": 0.035}


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x22b",
                                  "mamba2_2_7b", "whisper_medium"])
def test_meta_flops_within_3_percent_of_xla(arch):
    """A reduced evaluation (loss and gradient, B 2, S 64, f32, remat), the
    plain paths on both sides (the reference's dry-run builds its models
    with ``kernels="reference"``): the port's meta FLOPs, products and
    elementwise work counted XLA's way (``flops + elementwise_flops``),
    within ±3 % of XLA's count of the program before its passes, and of
    the compiled program's (mamba2: ``XLA_COMPILED_TOL``)."""
    ev = _meta_evaluation(get_config(arch).reduced())
    with C.CostCount() as cc:
        ev()
    compiled, lowered = _xla_flops(arch)
    c = cc.count
    assert c.kernel_flops == 0 and c.launches == {}
    assert c.elementwise_flops > 0
    total = c.flops + c.elementwise_flops
    assert abs(total / lowered - 1.0) <= 0.03, total / lowered
    assert abs(total / compiled - 1.0) <= \
        XLA_COMPILED_TOL.get(arch, 0.03), total / compiled


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "jamba_v0_1_52b"])
def test_meta_aten_flops_equal_flop_counter_on_cpu(arch):
    """The count's aten FLOPs follow ``FlopCounterMode``'s rule: the same
    evaluation on meta tensors and for real on the CPU count the same."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config(arch).reduced()
    with C.CostCount() as cc:
        _meta_evaluation(cfg)()
    ev = _meta_evaluation(cfg, device="cpu")
    with FlopCounterMode(display=False) as fcm:
        ev()
    assert cc.count.aten_flops == fcm.get_total_flops() > 0


# ---------------------------------------------------------------------------
# the production meshes and the extrapolation
# ---------------------------------------------------------------------------
def _blocks_cfg(arch, n_blocks=3):
    """The reduced config with ``n_blocks`` layer blocks (and as many
    encoder layers for the enc-dec family)."""
    import dataclasses

    from repro_torch.models.transformer import stack_plan
    cfg = get_config(arch).reduced()
    _, block, _ = stack_plan(cfg)
    kw = {"num_layers": cfg.first_dense + n_blocks * len(block)}
    if cfg.family == "encdec":
        kw["encoder_layers"] = n_blocks
    return dataclasses.replace(cfg, **kw)


def _count(cfg, mesh, shape=MESH_SMALL, isgd_stop=5):
    step = dryrun.build_step(dryrun._meta_model(cfg), mesh, shape,
                             isgd_stop=isgd_stop)
    return dryrun.count_step(step)[0], step


@pytest.mark.parametrize("family", list(FAMILIES))
def test_extrapolation_equals_full_depth(family, fake_world):
    cfg = _blocks_cfg(FAMILIES[family])
    mesh = make_production_mesh()
    full, _ = _count(cfg, mesh, isgd_stop=1)     # one trip: the same ops
    parts = []
    for k in (1, 2):
        cfg_k, n_blocks = dryrun._cfg_with_blocks(cfg, k)
        parts.append(_count(cfg_k, mesh, isgd_stop=1)[0])
    assert n_blocks == 3
    x = dryrun.extrapolate(*parts, n_blocks)
    assert x.flops_by_dtype == dict(full.flops_by_dtype)
    assert x.aten_flops == full.aten_flops
    assert x.kernel_flops == full.kernel_flops
    assert x.elementwise_flops == full.elementwise_flops
    assert x.bytes == full.bytes
    assert x.launches == dict(full.launches)
    assert x.kernels == full.kernels
    assert x.by_group() == full.by_group()
    assert x.collective_stats() == full.collective_stats()


def _spec_numel(shape, spec, sizes):
    n = int(np.prod(shape))
    for a in spec:
        if a is not None:
            n //= sizes.get(a, 1)
    return n


@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
def test_reduced_arch_under_production_mesh(multi_pod, fake_world):
    """Rank 0 of the 256- or 512-rank fake mesh runs a reduced
    ``internlm2`` step (the global ``train_4k`` batch): its argument bytes
    are its local shards (each parameter cut as its spec says) of params,
    of the momentum and Alg. 2 state, and the batch it is handed; its
    collectives are one reduce-scatter an evaluation over the flat data
    group (the data mean), two a split MLP layer an evaluation over the
    model group (the model-axis sums, ``axis_sum``: the output's in the
    forward and the input gradient's in the backward; the recomputation
    stops before the output's sum), and all-gathers: of the means over
    the flat data group, of the parameters over the data axis and the
    model group, of the sums and the hidden stream's slices over the
    model group, and on the 512-rank mesh of the slice means over the pod
    ranks."""
    from repro_torch.launch.shardings import hybrid_params_placement
    from repro_torch.sharding import rules
    mesh = make_production_mesh(multi_pod)
    assert mesh.size() == (512 if multi_pod else 256)
    cfg = get_config("internlm2_1_8b").reduced()
    shape = INPUT_SHAPES["train_4k"]
    c, step = _count(cfg, mesh, shape)
    sizes = rules.axis_sizes(mesh)
    model = build_model(cfg, device="meta")
    _, pl = hybrid_params_placement(mesh, model.module)
    numel = [_spec_numel(lf.shape, lf.spec, sizes) for lf in pl.leaves]
    local = sum(n * lf.local.element_size() for n, lf in zip(numel, pl.leaves))
    assert local == sum(t.nbytes for t in pl.local)
    state = (4 * sum(numel) + local    # f32 velocity, Alg. 2's w0
             + 4 * 64 + 4 + 4 + 4 + 4  # queue: buf, Σ, Σ², count, idx
             + 3 * 4                   # iter, accel_count, sub_iters
             + 4 + 1 + 4 + 4)          # trips: psi, live, limit, zeta
    batch = shape.global_batch * shape.seq_len * 4
    assert step.arg_bytes == c.arg_bytes == local + state + batch
    flat_data = tuple(range(0, mesh.size(), 16))   # the reduction's
    data_axis = tuple(range(0, 256, 16))           # FSDP's, within a pod
    model_g = tuple(range(16))
    pod_g = (0, 256)                               # a slice's two keepers
    groups = collections.Counter(r.ranks for r in c.collectives)
    assert {r.kind for r in c.collectives} == {"all-gather", "reduce-scatter"}
    assert set(groups) == {flat_data, data_axis, model_g} | (
        {pod_g} if multi_pod else set())
    scatters = collections.Counter(r.ranks for r in c.collectives
                                   if r.kind == "reduce-scatter")
    assert scatters == {flat_data: 1 + 5,           # one an evaluation
                        model_g: 2 * cfg.num_layers * (1 + 5)}
    assert c.launches == {"flash_attention": 2 * 2 * (1 + 5),
                          "fused_xent": 1 + 5}


def test_dryrun_step_at_one_rank_mesh_counts_the_cpu_run(tmp_path,
                                                        fake_world):
    """What ``chip_smoke.py``'s analysis phase holds on the card, here on
    the CPU: ``dryrun.build_step`` at mesh (data=1, model=1) over a
    one-rank gloo group makes the same step on meta tensors and on the
    CPU; in analysis mode the meta count's aten FLOPs equal
    ``FlopCounterMode``'s count of the CPU run exactly, the step evaluates
    the loss 1 + stop times on both, and the one-rank reduction records no
    collective."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_host_mesh
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    mesh = make_host_mesh(1, device="cpu", backend="gloo")
    cfg = zoo_config("transformer", "tiny")
    shape = InputShape("tiny", 32, 4, "train")
    stop = 3
    evals = {}

    def built(device, batch=None):
        model = build_model(cfg, kernels="reference", device=device)
        loss_fn = model.loss_fn
        evals[device] = 0

        def counted(b):
            evals[device] += 1
            return loss_fn(b)

        model.loss_fn = counted
        return dryrun.build_step(model, mesh, shape, isgd_stop=stop,
                                 batch=batch)

    c, _ = dryrun.count_step(built("meta"))
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (shape.global_batch, shape.seq_len)).astype(np.int32)
    step = built("cpu", {"tokens": torch.from_numpy(tokens)})
    assert step.arg_bytes == c.arg_bytes
    evals["cpu"] = 0
    with analysis_mode(), FlopCounterMode(display=False) as fcm:
        step.run()
    assert c.aten_flops == fcm.get_total_flops() > 0
    assert evals == {"meta": 1 + stop, "cpu": 1 + stop}
    assert c.collectives == [] and dryrun._mesh_name(mesh) == "1datax1model"


def test_production_mesh_refuses_a_real_group(tmp_path, fake_world):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    with pytest.raises(MeshError, match="real gloo group"):
        make_production_mesh()


# ---------------------------------------------------------------------------
# the kernels' cost() and their meta branches
# ---------------------------------------------------------------------------
def test_cost_at_main_shapes_is_the_smoke_formula():
    """The formulas ``chip_smoke.py`` inlined before, at its main shapes
    (``XENT_MAIN``, ``ATTN_MAIN``, ``SSD_MAIN``), bf16: the bounds of
    ``PERF.md`` (0.5559, 0.01739, 0.04163 ms) come out the same."""
    from repro_torch.kernels.flash_attention.kernel import cost as attn_cost
    from repro_torch.kernels.fused_xent.kernel import cost as xent_cost
    from repro_torch.kernels.ssd_scan.kernel import cost as ssd_cost
    N, d, Vp = 8192, 1024, 32768
    assert xent_cost(N, d, Vp) == (2.0 * N * d * Vp,
                                   (N * d + d * Vp) * 2 + N * 4 + N * 4)
    B, S, H, K, hd = 8, 1024, 16, 8, 64
    pairs = int(np.tril(np.ones((S, S), bool)).sum())
    assert attn_cost(B, S, S, H, K, hd) == (
        4.0 * B * H * hd * pairs, (2 * B * S * H * hd + 2 * B * S * K * hd) * 2)
    b, S2, nh, hd2, G, ds, chunk = 8, 1024, 32, 64, 1, 128, 256
    N2, cl = b * S2 // chunk, chunk
    assert ssd_cost(N2, cl, nh, hd2, G, ds) == (
        N2 * nh * (cl * (cl + 1) / 2 * 2 * (ds + hd2) + 2 * cl * hd2 * ds),
        (N2 * cl * nh * hd2 + 2 * N2 * cl * G * ds) * 2
        + (N2 * cl * nh + nh) * 4
        + (N2 * cl * nh * hd2 + N2 * nh * hd2 * ds + N2 * nh) * 4)
    bound = {k: max(o / 989e12, n / 3.35e12) * 1e3 for k, (o, n) in {
        "xent": xent_cost(N, d, Vp), "attn": attn_cost(B, S, S, H, K, hd),
        "ssd": ssd_cost(N2, cl, nh, hd2, G, ds)}.items()}
    assert (round(bound["xent"], 4), round(bound["attn"], 5),
            round(bound["ssd"], 5)) == (0.5559, 0.01739, 0.04163)


@pytest.mark.parametrize("window", [None, 5])
def test_live_pairs_match_the_mask(window):
    from repro_torch.kernels.flash_attention.kernel import live_pairs
    for Sq, Sk, causal in ((37, 37, True), (40, 29, True), (23, 31, False)):
        q = np.arange(Sq)[:, None]
        k = np.arange(Sk)[None, :]
        keep = np.ones((Sq, Sk), bool)
        if causal:
            keep &= k <= q
        if window:
            keep &= k > q - window
        assert live_pairs(Sq, Sk, causal, window) == int(keep.sum())


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("kernel", ["fused_xent", "flash_attention",
                                    "ssd_scan"])
def test_meta_branch_records_its_cost(kernel):
    """On meta tensors a wrapper returns its kernel's outputs (shapes and
    dtypes) and records its launches, exactly its ``cost()`` in all (the
    flash kernel at hd 256 in bf16: what its two launches do, 1.5× the
    q·k products of ``cost()``); it runs no aten op that carries FLOPs
    (the plain version would)."""
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.fused_xent import kernel as FX
    from repro_torch.kernels.ssd_scan import kernel as SS
    with C.CostCount() as cc:
        if kernel == "fused_xent":
            out = FX.fused_xent(_meta(96, 64), _meta(64, 512),
                                _meta(96, dtype=torch.int32), 500)
            want = FX.cost(96, 64, 512)
            shapes = [((96,), torch.float32)]
        elif kernel == "flash_attention":
            out = FA.flash_attention(_meta(2, 48, 8, 256), _meta(2, 48, 2, 256),
                                     _meta(2, 48, 2, 256), window=16)
            # hd 256 in bf16: two launches, each the whole q·k and half
            # of P·v, reading q and k whole and half of v, writing half of o
            per = FA.launch_costs(2, 48, 48, 8, 2, 256, torch.bfloat16, True, 16)
            pairs = FA.live_pairs(48, 48, True, 16)
            q_o, k_v = 2 * 48 * 8 * 256, 2 * 48 * 2 * 256
            assert per == [(3.0 * 2 * 8 * 256 * pairs,
                            (q_o + k_v + k_v // 2 + q_o // 2) * 2)] * 2
            assert FA.launch_costs(2, 48, 48, 8, 2, 128, torch.bfloat16, True,
                                   16) == [FA.cost(2, 48, 48, 8, 2, 128,
                                                   torch.bfloat16, True, 16)]
            want = (sum(o for o, _ in per), sum(b for _, b in per))
            shapes = [((2, 48, 8, 256), torch.bfloat16)]
        else:
            out = SS.ssd_intra_chunk(_meta(6, 16, 4, 32), _meta(6, 16, 4, dtype=torch.float32),
                                     _meta(4, dtype=torch.float32), _meta(6, 16, 2, 8),
                                     _meta(6, 16, 2, 8))
            want = SS.cost(6, 16, 4, 32, 2, 8)
            shapes = [((6, 16, 4, 32), torch.float32), ((6, 4, 32, 8), torch.float32),
                      ((6, 4), torch.float32)]
    outs = [out] if torch.is_tensor(out) else list(out)
    assert [(tuple(t.shape), t.dtype) for t in outs] == shapes
    assert all(t.device.type == "meta" for t in outs)
    c = cc.count
    assert c.launches == {kernel: 2 if kernel == "flash_attention" else 1}
    assert c.kernels == {kernel: {"ops": want[0], "bytes": want[1]}}
    assert (c.kernel_flops, c.kernel_bytes, c.aten_flops) == (want[0], want[1], 0)


def test_peak_counts_the_softmax_backward_temporaries():
    """The live-bytes peak: storages made inside the count, plus, inside a
    softmax backward given a non-contiguous gradient, its contiguous copy
    and a contiguous result (``count._CONTIGUOUS_INPUTS``)."""
    x = torch.empty((4, 8, 16), device="meta", requires_grad=True)
    n = 4 * 8 * 16 * 4
    for contiguous in (True, False):
        with C.CostCount() as cc:
            y = torch.softmax(x, dim=-1)
            g = torch.empty((4, 16, 8), device="meta")
            g = g if contiguous else g.transpose(1, 2)
            if contiguous:
                g = g.reshape(4, 8, 16)
            (gx,) = torch.autograd.grad(y, x, g)
        # y, g, gx live at once; the non-contiguous case adds two temporaries
        assert cc.count.temp_peak == (3 if contiguous else 5) * n
        del y, g, gx


# ---------------------------------------------------------------------------
# the CLI: what slice A17b must add
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--shape", "prefill_32k"], ["--shape", "decode_32k"],
    ["--shape", "long_500k"], ["--shape", "train_4k", "--cache-shard", "batch"],
    ["--shape", "train_4k", "--remat-policy", "tp_out"]], ids=" ".join)
def test_serving_and_its_levers_raise_naming_a17b(argv):
    with pytest.raises(dryrun.A17bError, match="A17b"):
        dryrun.main(argv)


def test_serving_pair_of_the_api_raises():
    for run in (dryrun.dryrun_one, dryrun.analysis_one):
        with pytest.raises(dryrun.A17bError, match="A17b"):
            run("internlm2_1_8b", "decode_32k", out_dir=None, quiet=True)


def test_all_lists_serving_pairs_as_skip(monkeypatch, capsys, tmp_path,
                                         fake_world):
    """``--all`` over one architecture (reduced here): the train pair
    passes and writes its record, the three serving pairs are SKIP (A17b),
    and the run exits 0."""
    monkeypatch.setattr(dryrun, "ARCH_IDS", ["internlm2_1_8b"])
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    assert dryrun.main(["--all", "--mode", "analysis",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("not ported (A17b)") == 3
    assert [l for l in out.splitlines() if l.startswith("PASS")] == [
        l for l in out.splitlines()
        if l.startswith("PASS internlm2_1_8b × train_4k × 16datax16model")]
    assert len([l for l in out.splitlines() if l.startswith("PASS")]) == 1
    assert "ALL DRY-RUNS PASSED (1 run, 3 skipped" in out
    assert [p.name for p in tmp_path.iterdir()] == [
        "internlm2_1_8b_train_4k_16datax16model.json"]


def test_dryrun_one_writes_its_record(tmp_path, fake_world, monkeypatch,
                                      capsys):
    """The full-depth dry-run of a reduced arch: the PASS line, memory per
    device, GFLOP and collective GB, and a record whose roofline terms are
    the count's."""
    import json
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    rl = dryrun.dryrun_one("mixtral_8x22b", "train_4k", multi_pod=True,
                           out_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert out.startswith("PASS mixtral_8x22b × train_4k × 2podx16datax16model")
    assert "mem/device: args=" in out and "roofline: compute=" in out
    rec = json.loads((tmp_path / "mixtral_8x22b_train_4k_2podx16datax16model.json")
                     .read_text())
    assert rec["chips"] == 512 and rec["compute_s"] == rl.compute_s > 0
    assert rec["collective_s"] > 0 and rec["memory_s"] > 0
    assert rec["launches"] == {"flash_attention": 2 * 2 * 6, "fused_xent": 6}
    assert math.isclose(rec["hlo_gflops"] * 1e9,
                        sum(rec["flops_by_dtype"].values()), rel_tol=1e-12)
