"""Port vs JAX: the SSM family and the ``ssd_scan`` kernel's plain version.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the port's ``ssd_intra_chunk`` computes its plain version; the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests run
it. The kernel itself runs only on the card: ``test_torch_cuda.py``.

Tolerances: ``TOLERANCES["ssd_scan"]["float32"]`` for the kernel's outputs,
and the same with atol scaled by the reference's max-abs for gradients; the
``paper-ssm-tiny`` loss within 1e-5 relative and each gradient leaf within
1e-4 of its max-abs, as ``test_torch_model.py`` holds the dense model.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import zoo_config as j_zoo_config
from repro.kernels.ssd_scan.kernel import ssd_intra_chunk as j_ssd_intra_chunk
from repro.kernels.ssd_scan.ops import ssd_chunked_pallas as j_ssd_chunked_pallas
from repro.models import build_model as j_build_model
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import zoo_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels.numerics import SSD_EDGES, SSD_SHAPES, TOLERANCES
from repro_torch.kernels.ssd_scan import (chunk_len, ssd_chunked_kernel,
                                          ssd_intra_chunk,
                                          ssd_intra_chunk_plain)
from repro_torch.models import build_model
from repro_torch.models.ssm import ssd_chunked

torch.set_num_threads(2)
ST = TOLERANCES["ssd_scan"]["float32"]
# (b, S, nh, hd, G, ds, chunk): the shared grid, a chunk length that is no
# power of two (S = 100 with chunk 32 gives cl = 25), and the two-group case
# of tests/test_kernels.py
GRID = SSD_SHAPES + [(1, 100, 2, 16, 1, 8, 32), (2, 128, 4, 32, 2, 16, 64)]
CFG = zoo_config("ssm", "tiny")
JCFG = j_zoo_config("ssm", "tiny")


def _ssd_inputs(b, S, nh, hd, G, ds, seed=0, dt_shift=0.0):
    """numerics.check_case's draws: dt = softplus(N(dt_shift, 1)),
    A = −exp(0.3·N(0, 1))."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, S, nh, hd).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, S, nh) + dt_shift)).astype(np.float32)
    A = (-np.exp(rng.randn(nh) * 0.3)).astype(np.float32)
    B = rng.randn(b, S, G, ds).astype(np.float32)
    C = rng.randn(b, S, G, ds).astype(np.float32)
    return x, dt, A, B, C


def _close(port, ref, tol, scale=1.0):
    rtol, atol = tol
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("shape", GRID, ids=str)
def test_intra_chunk_matches_jax(shape):
    """The three outputs, B/C in their group layout on the port's side and
    repeated to every head on the JAX side (its wrapper's layout)."""
    b, S, nh, hd, G, ds, chunk = shape
    x, dt, A, B, C = _ssd_inputs(b, S, nh, hd, G, ds)
    cl = chunk_len(S, chunk)
    N = b * S // cl
    xr, dtr = x.reshape(N, cl, nh, hd), dt.reshape(N, cl, nh)
    Br, Cr = B.reshape(N, cl, G, ds), C.reshape(N, cl, G, ds)
    ref = j_ssd_intra_chunk(*map(jnp.asarray, (
        xr, dtr, A, np.repeat(Br, nh // G, axis=2), np.repeat(Cr, nh // G, axis=2))),
        interpret=True)
    ins = list(map(torch.from_numpy, (xr, dtr, A, Br, Cr)))
    for fn in (ssd_intra_chunk, ssd_intra_chunk_plain):
        out = fn(*ins)
        for o, r, want in zip(out, ref, [(N, cl, nh, hd), (N, nh, hd, ds), (N, nh)]):
            assert o.dtype == torch.float32 and tuple(o.shape) == want
            _close(o.numpy(), r, ST)
    assert ssd_intra_chunk.launches == 0


@pytest.mark.parametrize("shape", GRID, ids=str)
def test_chunked_matches_jax(shape):
    """y and the final state: the port's kernel path and its plain path
    against ``ssd_chunked_pallas`` (interpret) and ``ssd_chunked``."""
    b, S, nh, hd, G, ds, chunk = shape
    ins = _ssd_inputs(b, S, nh, hd, G, ds, seed=1)
    jy, js = j_ssd_chunked_pallas(*map(jnp.asarray, ins), chunk=chunk)
    ry, rs = JS.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    t = list(map(torch.from_numpy, ins))
    for fn, (y_ref, s_ref) in ((ssd_chunked_kernel, (jy, js)),
                               (ssd_chunked, (ry, rs))):
        y, state = fn(*t, chunk=chunk)
        assert y.shape == (b, S, nh, hd) and state.shape == (b, nh, hd, ds)
        _close(y.numpy(), y_ref, ST)
        _close(state.numpy(), s_ref, ST)


@pytest.mark.parametrize("shape", GRID, ids=str)
def test_chunked_grads_match_jax(shape):
    """Gradients in x, dt, A, B and C of a loss on both outputs. dt is
    drawn around softplus(−2) ≈ 0.13 (the model starts near 0.01): at the
    forward tests' dt (mean about 0.8) a chunk of 64 passes exp's f32 range
    above the diagonal and JAX's gradient is NaN (the quirk tested below)."""
    b, S, nh, hd, G, ds, chunk = shape
    ins = _ssd_inputs(b, S, nh, hd, G, ds, seed=2, dt_shift=-2.0)
    rng = np.random.RandomState(3)
    ry = rng.randn(b, S, nh, hd).astype(np.float32)
    rs = rng.randn(b, nh, hd, ds).astype(np.float32)

    def jloss(*a):
        y, s = j_ssd_chunked_pallas(*a, chunk=chunk)
        return jnp.sum(y * ry) + jnp.sum(s * rs)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))
    t = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, s = ssd_chunked_kernel(*t, chunk=chunk)
    loss = (y * torch.from_numpy(ry)).sum() + (s * torch.from_numpy(rs)).sum()
    for port, ref in zip(torch.autograd.grad(loss, t), jg):
        assert port.shape == ref.shape
        _close(port.numpy(), ref, ST, float(np.abs(np.asarray(ref)).max()))


def test_chunked_grad_of_one_output():
    """A loss on y alone (the model's case): the final state's gradient is
    None, and the backward still matches JAX."""
    b, S, nh, hd, G, ds, chunk = SSD_SHAPES[0]
    ins = _ssd_inputs(b, S, nh, hd, G, ds, seed=4, dt_shift=-2.0)
    jg = jax.grad(lambda *a: jnp.sum(j_ssd_chunked_pallas(*a, chunk=chunk)[0]),
                  argnums=(0, 4))(*map(jnp.asarray, ins))
    t = [torch.from_numpy(a).requires_grad_(i in (0, 4))
         for i, a in enumerate(ins)]
    y, _ = ssd_chunked_kernel(*t, chunk=chunk)
    for port, ref in zip(torch.autograd.grad(y.sum(), (t[0], t[4])), jg):
        _close(port.numpy(), ref, ST, float(np.abs(np.asarray(ref)).max()))


def test_segsum_gradient_is_finite_where_jax_overflows():
    """The reference quirk: ``_segsum`` takes exp over the whole cl×cl square
    before masking, so at chunk 256 with A = −16 and dt = 0.05 the upper
    triangle's exponent (up to 16·0.05·255 = 204) overflows and the masked
    0·inf makes JAX's gradient NaN. The port selects −inf before the exp:
    its values are the reference's, and its gradient is finite and equal to
    JAX's gradient of the same function computed at chunk 16, where no
    exponent overflows (the chunked algorithm is exact in the chunk).
    The port's select is in ``ssd_intra_chunk_plain``, the within-chunk
    terms of its plain ``ssd_chunked``."""
    b, S, nh, hd, G, ds = 1, 256, 2, 16, 1, 8
    x, _, _, B, C = _ssd_inputs(b, S, nh, hd, G, ds, seed=5)
    dt = np.full((b, S, nh), 0.05, np.float32)
    A = np.array([-1.0, -16.0], np.float32)
    ins = (x, dt, A, B, C)

    def jgrad(chunk):
        return jax.grad(lambda *a: jnp.sum(JS.ssd_chunked(*a, chunk=chunk)[0]),
                        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))

    j256, j16 = jgrad(256), jgrad(16)
    assert not all(np.isfinite(np.asarray(g)).all() for g in j256)
    jy = JS.ssd_chunked(*map(jnp.asarray, ins), chunk=256)[0]
    for fn in (ssd_chunked, ssd_chunked_kernel):
        t = [torch.from_numpy(a).requires_grad_(True) for a in ins]
        y, _ = fn(*t, chunk=256)
        _close(y.detach().numpy(), jy, ST)
        for port, ref in zip(torch.autograd.grad(y.sum(), t), j16):
            assert torch.isfinite(port).all()
            _close(port.numpy(), ref, ST, float(np.abs(np.asarray(ref)).max()))


def test_init_scale_dt_weighs_every_tile_of_a_long_chunk():
    """Why the long-chunk cases on the card draw dt as the model's init
    does, softplus(N(log(expm1(0.01)), 1)): there the terms that a kernel
    tiled in 64 positions could drop all weigh above both tolerances of
    ``ssd_scan``. They are the chunk state from all but the last tile (and
    from the first tile alone), the chunk's decay, and y from key tiles two
    or more back. At dt = softplus(N(0, 1)) (mean 0.8) none of them does.
    Each truncation is the plain version on the tail of the chunk, so
    states and y there see only the tiles they keep."""
    N, cl, nh, hd, ds = 2, 256, 8, 64, 128

    def tail(ins, start):
        x, dt, A, B, C = ins
        return x[:, start:], dt[:, start:], A, B[:, start:], C[:, start:]

    for shift, seen in ((math.log(math.expm1(0.01)), True), (0.0, False)):
        x, dt, A, B, C = map(torch.from_numpy,
                             _ssd_inputs(N, cl, nh, hd, 1, ds, seed=6, dt_shift=shift))
        ins = (x, dt, A, B, C)
        y, states, decays = ssd_intra_chunk_plain(*ins)
        dropped = [(ssd_intra_chunk_plain(*tail(ins, 192))[1], states),   # last tile only
                   (ssd_intra_chunk_plain(*tail(ins, 64))[1], states),    # no first tile
                   (torch.zeros_like(decays), decays),
                   (ssd_intra_chunk_plain(*tail(ins, 128))[0][:, 64:],    # two key tiles
                    y[:, 192:])]
        for rtol, atol in TOLERANCES["ssd_scan"].values():
            for cut, full in dropped:
                assert torch.allclose(cut, full, rtol=rtol, atol=atol) != seen, (
                    shift, rtol, float((cut - full).abs().max()))


def test_ssd_wrapper_checks_its_inputs():
    x, dt, A, B, C = map(torch.from_numpy, _ssd_inputs(2, 32, 4, 16, 2, 8))
    ssd_intra_chunk(x, dt, A, B, C)                            # valid
    with pytest.raises(ValueError):
        ssd_intra_chunk(x[..., :8], dt, A, B, C)               # head_dim 8
    with pytest.raises(ValueError):
        ssd_intra_chunk(x, dt, A, B[:, :, :1].expand(-1, -1, 3, -1),
                        C[:, :, :1].expand(-1, -1, 3, -1))     # 4 heads, 3 groups
    with pytest.raises(ValueError):
        ssd_intra_chunk(x.repeat(1, 9, 1, 1), dt.repeat(1, 9, 1), A,
                        B.repeat(1, 9, 1, 1), C.repeat(1, 9, 1, 1))  # cl 288
    with pytest.raises(ValueError):
        ssd_intra_chunk(x, dt, A, B.repeat(1, 1, 1, 17), C.repeat(1, 1, 1, 17))
    with pytest.raises(ValueError):
        ssd_intra_chunk(x, dt, A, B, C[:, :16])
    with pytest.raises(ValueError):
        ssd_intra_chunk(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                        B, C)                                  # hd not unit-stride
    with pytest.raises(TypeError):
        ssd_intra_chunk(x.double(), dt, A, B.double(), C.double())
    with pytest.raises(TypeError):
        ssd_intra_chunk(x, dt.to(torch.bfloat16), A, B, C)
    # meta tensors (the analysis tier): the outputs' shapes, no launch
    outs = ssd_intra_chunk(*(t.to("meta") for t in (x, dt, A, B, C)))
    N, cl, nh, hd = x.shape
    assert [tuple(o.shape) for o in outs] == [
        (N, cl, nh, hd), (N, nh, hd, B.shape[3]), (N, nh)]
    assert all(o.device.type == "meta" for o in outs)
    assert ssd_intra_chunk.launches == 0


# ---------------------------------------------------------------------------
# the bf16 route of the kernel: its rounding points and its layouts
# ---------------------------------------------------------------------------
def _xbc_inputs(b, S, nh, hd, G, ds, chunk, dt_shift=0.0, seed=0):
    """The card's checks' draws (chip_smoke.ssd_inputs): x, B and C as views
    of one (b, S, nh·hd + 2·G·ds) tensor rounded to bf16 (held in f32 here),
    dt = softplus(N(dt_shift, 1)), A = −exp(0.3·N(0, 1)); chunked to
    (N, cl, ...) as the kernel takes them."""
    rng = np.random.RandomState(seed)
    di = nh * hd
    xbc = torch.from_numpy(rng.randn(b, S, di + 2 * G * ds).astype(np.float32))
    xbc = xbc.to(torch.bfloat16).to(torch.float32)
    dt = np.log1p(np.exp(rng.randn(b, S, nh) + dt_shift)).astype(np.float32)
    A = (-np.exp(rng.randn(nh) * 0.3)).astype(np.float32)
    cl = chunk_len(S, chunk)
    N = b * S // cl
    return (xbc[..., :di].reshape(N, cl, nh, hd), torch.from_numpy(dt).reshape(N, cl, nh),
            torch.from_numpy(A), xbc[..., di:di + G * ds].reshape(N, cl, G, ds),
            xbc[..., di + G * ds:].reshape(N, cl, G, ds))


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _kernel_arith(x, dt, A, B, C, p_terms=2):
    """The bf16 kernel's arithmetic, in torch on bf16-valued f32 inputs:
    S = C·Bᵀ accumulated in f32; P = S ⊙ exp(cum_i − cum_j) ⊙ dt_j in f32
    (zero selected above the diagonal), then as two bf16 terms (its
    rounding and the rounding of the remainder) or, with p_terms=1, rounded
    once; y = P·x accumulated in f32; the state's operand x·dt·w rounded to
    bf16 once, states = x̃ᵀ·B in f32; decays in f32."""
    N, cl, nh, hd = x.shape
    rep = nh // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)
    cum = torch.cumsum(dt * A, dim=1).transpose(1, 2)                 # (N, nh, cl)
    diff = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones(cl, cl, dtype=torch.bool).tril()
    L = torch.exp(torch.where(tri, diff, torch.full_like(diff, -math.inf)))
    P = torch.einsum("nihd,njhd->nhij", Ch, Bh) * L * dt.transpose(1, 2)[:, :, None, :]
    hi = _bf16(P)
    Pk = hi + _bf16(P - hi) if p_terms == 2 else hi
    y = torch.einsum("nhij,njhp->nihp", Pk, x)
    w = torch.exp(cum[..., -1:] - cum).transpose(1, 2)                 # (N, cl, nh)
    states = torch.einsum("njhp,njhd->nhpd", _bf16(x * (dt * w)[..., None]), Bh)
    return y, states, torch.exp(cum[..., -1])


def _jax_intra(ins):
    x, dt, A, B, C = (t.numpy() for t in ins)
    rep = x.shape[2] // B.shape[2]
    return j_ssd_intra_chunk(*map(jnp.asarray, (
        x, dt, A, np.repeat(B, rep, axis=2), np.repeat(C, rep, axis=2))), interpret=True)


BT = TOLERANCES["ssd_scan"]["bfloat16"]


@pytest.mark.parametrize("case", [
    ((2, 256, 2, 64, 1, 128, 256), math.log(math.expm1(0.01))),   # chunk 256, init dt
    ((1, 100, 3, 64, 1, 32, 32), 0.0),                             # cl = 25
    ((2, 128, 4, 32, 2, 16, 64), 0.0)], ids=str)                    # two groups
def test_bf16_rounding_points_fit_the_tolerance(case):
    """The bf16 kernel's rounding points, emulated in torch, against the JAX
    ``ssd_intra_chunk`` (interpret) on the same bf16-valued inputs, within
    the bf16 tolerance: what the card's check will see, before the card."""
    shape, shift = case
    ins = _xbc_inputs(*shape, dt_shift=shift)
    for o, r in zip(_kernel_arith(*ins), _jax_intra(ins)):
        _close(o.numpy(), r, BT)


def test_p_rounded_once_misses_the_bf16_tolerance():
    """Why the kernel carries P in two bf16 terms: P = C·Bᵀ ⊙ L ⊙ dt rounded
    once to bf16 puts y outside the bf16 tolerance (an error of about 0.1
    where y is small) on the ragged chunk at dt ≈ 0.8, where the two-term P
    stays within it by two orders of magnitude. The state's single rounding
    fits (the test above)."""
    ins = _xbc_inputs(1, 100, 3, 64, 1, 32, 32)
    ref = _jax_intra(ins)[0]
    once = _kernel_arith(*ins, p_terms=1)[0].numpy()
    twice = _kernel_arith(*ins, p_terms=2)[0].numpy()
    rtol, atol = BT
    assert not np.allclose(once, ref, rtol=rtol, atol=atol)
    assert np.abs(twice - np.asarray(ref)).max() < atol / 100


@pytest.mark.parametrize("edge", [e for e in SSD_EDGES if e[0] * e[1] * e[2] <= 4096],
                         ids=str)
def test_ssd_plain_matches_jax_at_tma_edges(edge):
    """The plain version (what the card's kernel is held to) against the JAX
    package at the edges of the bf16 route (``numerics.SSD_EDGES``), f32."""
    *shape, init_dt = edge
    ins = _xbc_inputs(*shape, dt_shift=math.log(math.expm1(0.01)) if init_dt else 0.0)
    for o, r in zip(ssd_intra_chunk(*ins), _jax_intra(ins)):
        _close(o.numpy(), r, ST)


def _model_layout(b, S, nh, hd, G, ds, chunk):
    """x, B and C as the SSM mixer hands them to the kernel: views of the
    convolution's bf16 (b, S, di + 2·G·ds) output, chunked by ``_forward``."""
    di = nh * hd
    xbc = torch.zeros(b, S, di + 2 * G * ds, dtype=torch.bfloat16)
    cl = chunk_len(S, chunk)
    N = b * S // cl
    return (xbc[..., :di].reshape(b, S, nh, hd).reshape(N, cl, nh, hd),
            xbc[..., di:di + G * ds].reshape(b, S, G, ds).reshape(N, cl, G, ds),
            xbc[..., di + G * ds:].reshape(b, S, G, ds).reshape(N, cl, G, ds))


def test_bf16_ssd_layout_check_takes_the_models_layouts():
    """The bf16 route's TMA layout check takes every layout the model and
    the card's checks give it: both tiers of ``paper-ssm``, every
    ``SSD_SHAPES`` and ``SSD_EDGES`` shape, the ragged and two-group cases."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    shapes = [s for s in SSD_SHAPES] + [tuple(e[:7]) for e in SSD_EDGES]
    shapes += [(1, 100, 2, 16, 1, 8, 32), (2, 128, 4, 32, 2, 16, 64)]
    for tier in ("tiny", "base"):
        c = zoo_config("ssm", tier)
        shapes.append((1, 2 * c.ssm_chunk, c.ssm_nheads, c.ssm_headdim, c.ssm_ngroups,
                       c.ssm_state, c.ssm_chunk))
    for shape in shapes:
        ssd_kernel._check_bf16_layout(*_model_layout(*shape))


@pytest.mark.parametrize("offset", [1, 2, 4, 7])
def test_bf16_ssd_layout_check_refuses_what_tma_cannot_take(offset):
    """A base address ``offset`` elements off 16 bytes, or a head, position
    or chunk stride that is 4 elements off a multiple of 8, is refused; the
    stride of a dimension of length 1 is never read."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    x, B, C = _model_layout(2, 128, 4, 32, 1, 16, 64)
    buf = torch.zeros(x.numel() * 2 + 8, dtype=torch.bfloat16)
    bad = [buf[offset:offset + x.numel()].view(x.shape),                 # base address
           buf.as_strided(x.shape, (x.stride(0), x.stride(1), 36, 1)),    # head stride 36
           buf.as_strided(x.shape, (x.stride(0), 4 * 36 + 4, 36, 1))]     # position stride
    for bx in bad:
        with pytest.raises(ValueError):
            ssd_kernel._check_bf16_layout(bx, B, C)
    with pytest.raises(ValueError):
        ssd_kernel._check_bf16_layout(x, B, buf[offset:offset + C.numel()].view(C.shape))
    one = buf.as_strided((2, 64, 1, 32), (64 * 40, 40, 12, 1))           # one head, stride 12
    ssd_kernel._check_bf16_layout(one, B, C)


# ---------------------------------------------------------------------------
# the paper-ssm model
# ---------------------------------------------------------------------------
def _jax_params(seed=0):
    return JT.init_params(jax.random.PRNGKey(seed), JCFG, dtype=jnp.float32)


def test_ssm_configs_match_jax():
    for tier in ("tiny", "base"):
        a, b = zoo_config("ssm", tier), j_zoo_config("ssm", tier)
        for f in ("family", "num_layers", "d_model", "d_ff", "vocab_size",
                  "norm_eps", "tie_embeddings", "padded_vocab", "ssm_state",
                  "ssm_headdim", "ssm_expand", "ssm_chunk", "ssm_ngroups",
                  "conv_width", "d_inner", "ssm_nheads"):
            assert getattr(a, f) == getattr(b, f), (tier, f)
        assert a.param_count() == b.param_count()
        assert a._is_attn_layer(0) == b._is_attn_layer(0)
    assert zoo_config("ssm", "base").param_count() == 225_551_872


@pytest.mark.parametrize("kernels,j_kernels", [("cuda", "interpret"),
                                               ("reference", "reference")])
def test_tiny_ssm_matches_jax(kernels, j_kernels):
    jp = _jax_params()
    toks = np.random.RandomState(0).randint(
        0, CFG.vocab_size, size=(2, 64)).astype(np.int32)
    jm = j_build_model(JCFG, kernels=j_kernels, param_dtype=jnp.float32)
    (jl, jaux), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})

    m = build_model(CFG, kernels=kernels, param_dtype=torch.float32,
                    device="cpu")
    m.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), CFG))
    total, aux = m.loss_fn({"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(total, m.params())
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)

    names = [n for n, _ in m.module.named_parameters()]
    port = params_to_jax(dict(zip(names, grads)), CFG)
    ref = jax.tree.map(np.asarray, jg)
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-4 * float(np.abs(b).max())), port, ref)


def test_ssm_params_round_trip_exact():
    tree = jax.tree.map(np.asarray, _jax_params(seed=3))
    back = params_to_jax(params_from_jax(tree, CFG), CFG)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), back, tree)
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    back = params_to_jax(params_from_jax(bf, CFG), CFG)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.view(np.uint16),
                                                            b.view(np.uint16)),
                 back, bf)


@pytest.mark.parametrize("tier", ["tiny", "base"])
def test_init_ssm_leaves_match_jax(tier):
    """The port's init fills the SSM leaves as ``init_ssm`` does, in the
    same tree, shapes and dtypes (bf16 weights, f32 A_log/D/dt_bias/gnorm).
    D, dt_bias, gnorm, conv_b and the norms are bit-equal. A_log is held
    within one f32 ulp: XLA's f32 log on the CPU is not correctly rounded
    (log(linspace(1, 16, 8)) differs from the correctly rounded value in
    the last bit), and torch's is. The base tier keeps its widths and is
    cut to one layer and a 256-token vocabulary."""
    cut = dict(num_layers=1, vocab_size=256) if tier == "base" else {}
    cfg = dataclasses.replace(zoo_config("ssm", tier), **cut)
    jcfg = dataclasses.replace(j_zoo_config("ssm", tier), **cut)
    jtree = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                           jax.random.PRNGKey(0))
    m = build_model(cfg, kernels="reference", param_dtype=torch.bfloat16,
                    device="cpu")
    m.init(0)
    port = params_to_jax(m.module.state_dict(), cfg)
    assert jax.tree.structure(port) == jax.tree.structure(jtree)
    for a, s in zip(jax.tree.leaves(port), jax.tree.leaves(jtree)):
        assert (a.shape, a.dtype.name) == (s.shape, s.dtype.name)
    jp = JS.init_ssm(jax.random.PRNGKey(0), jcfg)
    mix = port["blocks"][0]["mixer"]
    for name in ("D", "dt_bias", "gnorm", "conv_b"):
        ref = np.asarray(jp[name])
        for layer in mix[name]:
            np.testing.assert_array_equal(layer.view(np.uint8), ref.view(np.uint8))
    ref = np.asarray(jp["A_log"])
    for layer in mix["A_log"]:
        np.testing.assert_array_max_ulp(layer, ref, maxulp=1)
    for leaf in (port["final_norm"], port["blocks"][0]["ln1"]):
        assert not leaf.any()
