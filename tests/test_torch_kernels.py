"""Port vs JAX: the kernels' plain versions and their gradients.

On the CPU each port wrapper computes its plain PyTorch version; the JAX
side runs the Pallas kernels in interpret mode, as the JAX package's own
tests run them. Tolerances are the shared ``TOLERANCES[kernel]["float32"]``.
The kernels themselves run only on the card: ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import gqa_flash as j_gqa_flash
from repro.kernels.fused_xent import fused_xent as j_fused_xent
from repro.kernels.fused_xent.ops import fused_xent_sum as j_fused_xent_sum
from repro.kernels import numerics as J_numerics
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention, gqa_flash)
from repro_torch.kernels.flash_attention import kernel as attn_kernel
from repro_torch.kernels.fused_xent import (fused_xent, fused_xent_sum,
                                            xent_plain)
from repro_torch.kernels.fused_xent import kernel as xent_kernel
from repro_torch.kernels.numerics import (ATTN_EDGES, ATTN_SHAPES, SSD_SHAPES,
                                          TOLERANCES, XENT_EDGES, XENT_SHAPES,
                                          gqa_split)

torch.set_num_threads(2)
XT = TOLERANCES["fused_xent"]["float32"]
AT = TOLERANCES["flash_attention"]["float32"]


def _xent_inputs(N, d, Vp, V, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, d).astype(np.float32)
    w = (rng.randn(d, Vp) * 0.05).astype(np.float32)
    y = rng.randint(0, V, size=N).astype(np.int32)
    return h, w, y


def _attn_inputs(BH, S, hd, seed=0):
    B, H, K = gqa_split(BH)
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, S, K, hd).astype(np.float32)
    v = rng.randn(B, S, K, hd).astype(np.float32)
    return q, k, v


def _close(port, ref, tol, scale=1.0):
    rtol, atol = tol
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol * scale)


def test_tolerances_equal_jax():
    """The port's copies of the tolerance table and the shape grids."""
    assert TOLERANCES == J_numerics.TOLERANCES
    assert XENT_SHAPES == J_numerics.XENT_SHAPES
    assert ATTN_SHAPES == J_numerics.ATTN_SHAPES
    assert SSD_SHAPES == J_numerics.SSD_SHAPES


@pytest.mark.parametrize("shape", XENT_SHAPES, ids=str)
def test_xent_plain_matches_jax(shape):
    N, d, Vp, V = shape
    h, w, y = _xent_inputs(*shape)
    ref = j_fused_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y),
                       vocab_size=V, interpret=True)
    out = fused_xent(torch.from_numpy(h), torch.from_numpy(w),
                     torch.from_numpy(y), V)
    assert out.dtype == torch.float32 and out.shape == (N,)
    _close(out.numpy(), ref, XT)
    _close(xent_plain(torch.from_numpy(h), torch.from_numpy(w),
                      torch.from_numpy(y), V).numpy(), ref, XT)


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_attention_plain_matches_jax(shape):
    BH, S, hd, causal, window = shape
    q, k, v = _attn_inputs(BH, S, hd)
    ref = j_gqa_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = gqa_flash(tq, tk, tv, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == torch.float32
    _close(out.numpy(), ref, AT)
    _close(attention_plain(tq, tk, tv, causal=causal, window=window).numpy(),
           ref, AT)


@pytest.mark.parametrize("B,S,d,Vp,V,tied", [
    (2, 64, 32, 512, 500, False),    # padded vocab
    (3, 40, 48, 256, 256, True),     # w = embed.T, a transposed view
    (1, 1024, 16, 128, 128, False),  # S > 512: the backward's chunk loop
])
def test_xent_grads_match_jax(B, S, d, Vp, V, tied):
    rng = np.random.RandomState(1)
    h = rng.randn(B, S, d).astype(np.float32)
    w = (rng.randn(d, Vp) * 0.05).astype(np.float32)
    y = rng.randint(0, V, size=(B, S)).astype(np.int32)
    mask = (rng.rand(B, S) < 0.8).astype(np.float32)

    def jloss(h_, w_):
        tot, cnt = j_fused_xent_sum(h_, w_, jnp.asarray(y), jnp.asarray(mask), V)
        return tot / cnt

    jl, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))

    th = torch.from_numpy(h).requires_grad_(True)
    if tied:
        emb = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
        tw = emb.T
    else:
        emb = tw = torch.from_numpy(w).requires_grad_(True)
    tot, cnt = fused_xent_sum(th, tw, torch.from_numpy(y),
                              torch.from_numpy(mask), V)
    loss = tot / cnt
    dh, demb = torch.autograd.grad(loss, (th, emb))
    dw = demb.T if tied else demb
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for port, ref in ((dh, jdh), (dw, jdw)):
        scale = float(np.abs(np.asarray(ref)).max())
        _close(port.numpy(), ref, XT, scale)


@pytest.mark.parametrize("shape", [ATTN_SHAPES[1], ATTN_SHAPES[2],
                                   ATTN_SHAPES[3], ATTN_SHAPES[4]], ids=str)
def test_attention_grads_match_jax(shape):
    BH, S, hd, causal, window = shape
    q, k, v = _attn_inputs(BH, S, hd, seed=2)
    r = np.random.RandomState(3).randn(*q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(j_gqa_flash(q_, k_, v_, causal=causal, window=window) * r)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = gqa_flash(*ins, causal=causal, window=window)
    tg = torch.autograd.grad((out * torch.from_numpy(r)).sum(), ins)
    for port, ref in zip(tg, jg):
        scale = float(np.abs(np.asarray(ref)).max())
        _close(port.numpy(), ref, AT, scale)


def test_launch_count_counts_only_while_enabled_and_only_launches():
    """``launch_count`` adds where a wrapper bumps it, only while enabled,
    and only for the kernels it was enabled for; a wrapper given CPU
    tensors computes its plain version and launches (and bumps) nothing."""
    from repro_torch.kernels import launch_count
    h, w, y = _xent_inputs(*XENT_SHAPES[0])
    launch_count.bump("fused_xent")
    assert launch_count.read() == {}
    launch_count.enable("cpu", ["fused_xent", "flash_attention"])
    try:
        assert launch_count.read() == {"fused_xent": 0, "flash_attention": 0}
        launch_count.bump("fused_xent")
        launch_count.bump("fused_xent")
        launch_count.bump("ssd_scan")
        fused_xent(torch.from_numpy(h), torch.from_numpy(w),
                   torch.from_numpy(y), XENT_SHAPES[0][3])
        assert launch_count.read() == {"fused_xent": 2, "flash_attention": 0}
        launch_count.reset()
        assert launch_count.read() == {"fused_xent": 0, "flash_attention": 0}
    finally:
        launch_count.disable()
    assert launch_count.read() == {}


def test_wrappers_check_their_inputs():
    h, w, y = map(torch.from_numpy, _xent_inputs(16, 8, 256, 256))
    with pytest.raises(TypeError):
        fused_xent(h, w, y.long(), 256)                 # int64 labels
    with pytest.raises(TypeError):
        fused_xent(h, w.double(), y, 256)
    with pytest.raises(ValueError):
        fused_xent(h, w[:4], y, 256)                    # d mismatch
    with pytest.raises(ValueError):
        fused_xent(h, w, y, 300)                        # vocab > Vp
    # meta tensors (the analysis tier): the output's shape, no launch
    out = fused_xent(h.to("meta"), w.to("meta"), y.to("meta"), 256)
    assert out.device.type == "meta" and tuple(out.shape) == (16,)
    q, k, v = map(torch.from_numpy, _attn_inputs(8, 64, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1), v, causal=True)
    with pytest.raises(ValueError):
        flash_attention(q[..., :8], k[..., :8], v[..., :8])   # head_dim 8
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert fused_xent.launches == 0 and flash_attention.launches == 0


def test_bf16_layout_checks():
    """The rules of the tensor-core paths, checked on CPU tensors (on the
    card the wrappers apply them to every bf16 call): unit stride on the
    staged axis, strides in multiples of 8 elements, 16-byte alignment."""
    h = torch.zeros(64, 32, dtype=torch.bfloat16)
    w = torch.zeros(32, 256, dtype=torch.bfloat16)
    xent_kernel._check_bf16_layout(h, w)                        # untied head
    xent_kernel._check_bf16_layout(h, torch.zeros(256, 32, dtype=torch.bfloat16).T)
    for bad_h, bad_w in ((h.T.contiguous().T, w),               # h strided on d
                         (h, torch.zeros(32, 512, dtype=torch.bfloat16)[:, ::2]),
                         (torch.zeros(64, 36, dtype=torch.bfloat16)[:, 1:33], w),
                         (h[:, :28], w[:28])):                  # d not a multiple of 8
        with pytest.raises(ValueError):
            xent_kernel._check_bf16_layout(bad_h, bad_w)
    q = torch.zeros(2, 64, 4, 16, dtype=torch.bfloat16)
    kv = torch.zeros(2, 64, 2, 16, dtype=torch.bfloat16)
    attn_kernel._check_bf16_layout(q, kv, kv)
    attn_kernel._check_bf16_layout(q, kv[:, :, :1], kv[:, :, 1:])   # one KV head of two
    wide = torch.zeros(2, 64, 2, 20, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attn_kernel._check_bf16_layout(q, wide[..., :16], kv)      # head stride 20
    with pytest.raises(ValueError):
        attn_kernel._check_bf16_layout(q, kv.flatten()[1:2049].view(2, 64, 2, 8), kv)


# --- the host side of the bf16 wgmma + TMA routes -------------------------

@pytest.mark.parametrize("shape", [s for s in ATTN_EDGES if s[1] <= 512], ids=str)
def test_attention_plain_matches_jax_at_tma_edges(shape):
    """The plain version (what the card's kernel is held to) against the
    JAX package at the edges of the TMA route: every head dim, ragged S,
    non-causal, a window that starts inside a key tile."""
    B, S, H, K, hd, causal, window = shape
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, S, n, hd).astype(np.float32) for n in (H, K, K))
    ref = j_gqa_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window)
    _close(out.numpy(), ref, AT)


@pytest.mark.parametrize("shape", [s for s in XENT_EDGES if s[0] * s[2] <= 2**20],
                         ids=str)
def test_xent_plain_matches_jax_at_tma_edges(shape):
    """The same for ``fused_xent``: tied (transposed view) and untied
    heads, N below a token tile, d = 32 and 48, padded vocab."""
    N, d, Vp, V, tied = shape
    h, w, y = _xent_inputs(N, d, Vp, V)
    ref = j_fused_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y),
                       vocab_size=V, interpret=True)
    tw = (torch.from_numpy(np.ascontiguousarray(w.T)).T if tied
          else torch.from_numpy(w))
    out = fused_xent(torch.from_numpy(h), tw, torch.from_numpy(y), V)
    _close(out.numpy(), ref, XT)


def _misaligned(shape, offset, dtype=torch.bfloat16):
    """A tensor of ``shape`` whose data starts ``offset`` elements into a
    16-byte aligned buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[offset:offset + n].view(shape)


@pytest.mark.parametrize("offset", [1, 2, 4, 7])
def test_bf16_layout_checks_refuse_misaligned_pointers(offset):
    """TMA takes only 16-byte aligned base addresses: a bf16 tensor that
    starts 2, 4, 8 or 14 bytes past an aligned one is refused by both
    wrappers, and the aligned one is taken."""
    h, w = torch.zeros(64, 32, dtype=torch.bfloat16), torch.zeros(32, 256, dtype=torch.bfloat16)
    xent_kernel._check_bf16_layout(_misaligned((64, 32), 0), w)
    with pytest.raises(ValueError):
        xent_kernel._check_bf16_layout(_misaligned((64, 32), offset), w)
    with pytest.raises(ValueError):
        xent_kernel._check_bf16_layout(h, _misaligned((32, 256), offset))
    with pytest.raises(ValueError):                  # a tied head's embedding
        xent_kernel._check_bf16_layout(h, _misaligned((256, 32), offset).T)
    q = torch.zeros(2, 64, 4, 16, dtype=torch.bfloat16)
    kv = torch.zeros(2, 64, 2, 16, dtype=torch.bfloat16)
    attn_kernel._check_bf16_layout(_misaligned(q.shape, 0), kv, kv)
    for args in ((_misaligned(q.shape, offset), kv, kv),
                 (q, _misaligned(kv.shape, offset), kv),
                 (q, kv, _misaligned(kv.shape, offset))):
        with pytest.raises(ValueError):
            attn_kernel._check_bf16_layout(*args)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_bf16_attention_layout_checks_refuse_strides_tma_cannot_take(axis):
    """TMA's outer strides are multiples of 16 bytes: a q, k or v whose
    batch, position or head stride is 4 elements off a multiple of 8 is
    refused; the same view 8 elements off is taken."""
    storage = torch.zeros(2 * 64 * 4 * 32, dtype=torch.bfloat16)
    strides = [64 * 2 * 24, 2 * 24, 24]          # (B, S, K) strides, multiples of 8

    def view(extra):
        st = list(strides)
        st[axis] += extra
        return storage.as_strided((2, 64, 2, 16), (*st, 1))

    q = torch.zeros(2, 64, 4, 16, dtype=torch.bfloat16)
    attn_kernel._check_bf16_layout(q, view(8), view(8))
    for args in ((q, view(4), view(0)), (q, view(0), view(4)),
                 (torch.zeros(2 * q.numel(), dtype=torch.bfloat16).as_strided(
                     q.shape, [s + 4 * (i == axis) for i, s in
                               enumerate(q.stride()[:3])] + [1]),
                  view(0), view(0))):
        with pytest.raises(ValueError):
            attn_kernel._check_bf16_layout(*args)


def test_bf16_xent_layout_checks_refuse_strides_tma_cannot_take():
    """h and W rows whose stride is not a multiple of 8 elements are
    refused in either W layout; a W with no unit stride is refused."""
    h = torch.zeros(64, 32, dtype=torch.bfloat16)
    w = torch.zeros(32, 256, dtype=torch.bfloat16)
    emb = torch.zeros(256, 40, dtype=torch.bfloat16)[:, :32]    # rows 40 apart
    xent_kernel._check_bf16_layout(h, emb.T)
    xent_kernel._check_bf16_layout(torch.zeros(64, 40, dtype=torch.bfloat16)[:, :32], w)
    bad = [(torch.zeros(64, 36, dtype=torch.bfloat16)[:, :32], w),           # h rows 36 apart
           (h, torch.zeros(32, 260, dtype=torch.bfloat16)[:, :256]),         # W rows 260 apart
           (h, torch.zeros(256, 36, dtype=torch.bfloat16)[:, :32].T),        # embedding rows 36
           (h, torch.zeros(64, 512, dtype=torch.bfloat16)[::2, ::2])]        # no unit stride
    for bh, bw in bad:
        with pytest.raises(ValueError):
            xent_kernel._check_bf16_layout(bh, bw)


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("n_tiles,n_vt", [(64, 256), (1, 1), (1, 8), (3, 2),
                                          (16, 256), (64, 250), (200, 9),
                                          (7, 1000)])
def test_split_count_covers_every_vocab_tile_once(sms, n_tiles, n_vt):
    """For both routes, the split count the wrapper passes cuts the vocab
    tiles, as the kernel cuts them, into non-empty ranges that cover each
    tile exactly once."""
    for one_per_sm in (True, False):
        nsplit = xent_kernel.split_count(sms, n_tiles, n_vt, one_per_sm)
        ranges = xent_kernel.vocab_ranges(n_vt, nsplit)
        assert 1 <= nsplit <= n_vt
        assert all(b < e for b, e in ranges)
        tiles = [t for b, e in ranges for t in range(b, e)]
        assert tiles == list(range(n_vt))


def test_split_count_fills_one_wave_at_the_main_shape():
    """At the training shape (N = 8192, Vp = 32768 on 132 SMs) the bf16
    route runs 64 token tiles × 2 splits = 128 blocks of 128 vocab tiles,
    one wave of one block per SM; no split count finishes sooner."""
    n_tiles, n_vt, sms = 8192 // xent_kernel.BN, 32768 // xent_kernel.BV, 132
    nsplit = xent_kernel.split_count(sms, n_tiles, n_vt)
    assert nsplit == 2 and n_tiles * nsplit <= sms
    waves = lambda s: -(-n_tiles * s // sms) * (-(-n_vt // s) + 1)  # noqa: E731
    assert all(waves(nsplit) <= waves(s) for s in range(1, n_vt + 1))


def test_kernel_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """A library's file name hashes its source, the shared ``csrc/*.cuh``
    headers and the flags: editing the header rebuilds every kernel."""
    from repro_torch.kernels import build
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._lib_path(n) for n in build.SOURCES}
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._lib_path(n) for n in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
    (tmp_path / "fused_xent.cu").write_text("// edited\n")
    assert build._lib_path("fused_xent") != after["fused_xent"]
    assert build._lib_path("flash_attention") == after["flash_attention"]


# (B, H, Sq, Sk, causal, window, hd): the work list's edge cases
WORK_CASES = [(2, 3, 1024, 1024, True, 0, 64), (1, 2, 100, 100, True, 0, 128),
              (2, 2, 192, 192, False, 0, 32), (1, 4, 512, 512, True, 100, 64),
              (1, 1, 300, 200, True, 64, 16), (2, 2, 256, 384, False, 0, 64)]


@pytest.mark.parametrize("case", WORK_CASES, ids=str)
def test_work_items_visit_every_live_pair_once(case):
    """The bf16 kernel's work items, as the host mirrors them: every live
    (query, key) pair of every (batch, head) falls in exactly one visited
    key tile of exactly one item, and no pair is visited twice."""
    B, H, Sq, Sk, causal, window, hd = case
    tk = attn_kernel.key_tile(hd)
    seen = np.zeros((B, H, Sq, Sk), np.int32)
    for q0, h, b, kt0, ntiles in attn_kernel.work_items(B, H, Sq, Sk, causal,
                                                        window, hd):
        seen[b, h, q0:q0 + attn_kernel.TQ, kt0 * tk:(kt0 + ntiles) * tk] += 1
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    live = np.ones((Sq, Sk), bool)
    if causal:
        live &= k <= q
    if window:
        live &= k > q - window
    assert seen.max() <= 1
    assert (seen[:, :, live] == 1).all()


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("case", WORK_CASES, ids=str)
def test_schedule_gives_every_item_to_one_block_and_balances(case, sms):
    """The persistent grid's work lists take every item exactly once, and
    no block carries more than one item's cost beyond the lightest."""
    B, H, Sq, Sk, causal, window, hd = case
    items = attn_kernel.work_items(B, H, Sq, Sk, causal, window, hd)
    grid, table = attn_kernel.schedule(B, H, Sq, Sk, causal, window, hd, sms)
    assert grid == min(sms, len(items)) and len(table) == grid + 1 + len(items)
    starts, order = table[:grid + 1], table[grid + 1:]
    assert starts[0] == 0 and starts[-1] == len(items)
    assert sorted(order) == list(range(len(items)))
    cost = [sum(items[i][4] + attn_kernel.ITEM_COST
                for i in order[starts[g]:starts[g + 1]]) for g in range(grid)]
    assert max(cost) - min(cost) <= max(it[4] for it in items) + attn_kernel.ITEM_COST
