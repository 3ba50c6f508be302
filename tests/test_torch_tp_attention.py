"""Port vs JAX: the tensor-parallel attention's head plan.

``launch.shardings`` splits an attention layer over the M model ranks by
its head plan (``head_plan``): by heads where M divides H and K; by KV
groups where K < M, M % K == 0 and H ≥ M (the m = M/K ranks of a group
read one KV head and share out its rep = H/K query heads, the first
``rep mod m`` taking one more); whole otherwise. Storage stays the
reference's even column split, so a rank's compute slice may differ from
its storage slice, and every exchange stays inside the KV group.

  * (a) the plan, single process: at M = 16 the compute heads of every
    arch with attention (the table of the module doc of
    ``launch.shardings``: 1, 2, 3, 4/3 and 2/1 heads a rank), whisper's
    encoder and cross attention by heads, the group's storage slices
    covering its compute columns; reduced configs (H < M) and K, M that
    divide neither the other run whole; the specs of the split leaves
    equal the reference's;
  * (b) four gloo ranks on ``(1, 4)`` against the JAX per-step engine on
    the same numpy inputs, 3 steps, f32, plain paths: the tiny
    transformer at d 128, hd 32 with H 4, K 2 (even: one head a rank, KV
    groups of 2) and H 6, K 2 (uneven: 2 + 1 heads a group, storage and
    compute slices differ); the uneven one also on eight ranks, ``(2,
    4)``, its storage slices FSDP-split over data too; on every leg the
    whole params and velocity come back to the same shards through
    ``load_full`` and ``load_full_tree``;
  * (c) whisper's reduced config on ``(1, 2)``, its encoder and cross
    attention split, held the same way; and the fused engine with KV
    groups (the wide tiny transformer on ``(1, 4)``) bit for bit with the
    per-step one; the model-axis sum (``core.reduce.axis_sum``, a
    reduce-scatter then a gather) bit for bit with the gather form's
    rank-order f32 sum on 2, 3 and 4 ranks;
  * (d) the non-causal chunked backward (``models.layers._attend_chunked``,
    the encoder's and the cross attention's) against JAX's VJP of the
    reference's ``_attend_chunked``, within 2e-5 of max|ref|, at chunk 16;
  * (e) the ``train_4k`` dry-run count on the meta device
    (``launch.dryrun``) for ``deepseek_coder_33b``, ``whisper_medium``
    and ``deepseek_v2_lite_16b`` (its experts split, ``models.moe``; MLA
    whole) at 256 and 512 ranks through the two-point extrapolation over 1 and 2
    blocks (each block adds its parameters, gathered tensors, gradients,
    buckets and checkpoint, and an enc-dec model's encoder layer, so the
    memory sum grows by the same amount a block; ``PERF.md`` sets it
    beside the full-depth runs): memory a device within the card's 80
    GB.

Tolerances of (b) and (c), as ``test_torch_hybrid.py`` states them for
its tensor-parallel legs: losses within 2e-5 relative, limits alike,
decisions equal, every parameter within 2e-4·max|p| of its leaf (the
model-axis and KV-group sums reassociate f32); every rank holds the same
bits of every gathered parameter. The ranks run in spawns of their own
(``spawn_ranks``, ``TIMEOUT`` each), rank functions in
``tests/_torch_dist_workers.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from repro.configs import get_config as j_get_config
from repro.configs import zoo_config as j_zoo_config
from repro.core import ISGDConfig as JISGDConfig
from repro.models import build_model as j_build_model
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import momentum as j_momentum
from repro.sharding import rules as J
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.env import spawn_ranks
from repro_torch.launch.shardings import (HeadPlan, _split_plan, head_plan,
                                          query_heads)
from repro_torch.models import layers as L
from repro_torch.models.transformer import Transformer
from repro_torch.sharding import rules as R

torch.set_num_threads(2)
TIMEOUT = 150
STEPS, LR = 3, 0.05
M16 = {"data": 16, "model": 16}

# compute query heads of model ranks 0..15 at M = 16 (None: no attention)
HEADS_16 = {
    "internlm2_1_8b": [1] * 16, "internvl2_2b": [1] * 16,
    "gemma3_12b": [1] * 16, "jamba_v0_1_52b": [2] * 16,
    "mixtral_8x22b": [3] * 16, "deepseek_coder_33b": [4, 3] * 8,
    "starcoder2_3b": [2, 2, 2, 2, 1, 1, 1, 1] * 2,
    "whisper_medium": [1] * 16,
    "deepseek_v2_lite_16b": None, "mamba2_2_7b": None}


def rank_heads(H, K, M, c):
    """``(first query head, query heads, KV head or first, KV heads)``
    model rank c of M computes by ``head_plan``."""
    plan = head_plan(H, K, M)
    if plan.kind == "heads":
        return c * H // M, H // M, c * K // M, K // M
    assert plan.kind == "kv"
    g, j = divmod(c, plan.m)
    start, n = query_heads(plan.rep, plan.m, j)
    return g * plan.rep + start, n, g, 1


def _meta(cfg):
    with torch.device("meta"):
        return Transformer(cfg, dtype=torch.bfloat16, device="meta")


def _plan(cfg, M, data=1):
    model = _meta(cfg)
    named = list(model.named_parameters())
    specs = R.params_shardings({"data": data, "model": M}, named)
    return _split_plan(model, M, specs), dict(named), specs


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_head_plan_at_16_model_ranks(arch):
    cfg = get_config(arch)
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    want = HEADS_16[arch]
    plan, params, _ = _plan(cfg, 16, 16)
    attn = {n: sp for n, sp in plan.items()
            if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo")
            and ".mlp." not in n}
    if want is None:
        assert not attn
        return
    assert [rank_heads(H, K, 16, c)[1] for c in range(16)] == want
    assert sum(want) == H
    p = head_plan(H, K, 16)
    assert p.kind == ("heads" if K % 16 == 0 else "kv")
    slots = {n.split(".")[2] for n in attn}
    assert slots == ({"mixer", "cross"} if cfg.family == "encdec"
                     else {"mixer"})
    if cfg.family == "encdec":
        assert any(n.startswith("encoder.") for n in attn)
    for name, sp in attn.items():
        leaf = name.rsplit(".", 1)[-1]
        assert sp.dim == (0 if leaf == "wo" else 1)
        assert sp.m == (1 if p.kind == "heads" else p.m)
        if p.kind == "heads" or leaf in ("wk", "wv"):
            assert sp.narrows is None
            continue
        # the group's ranks deal out its rep heads in order, no gap
        assert [n // hd for _, n in sp.narrows] == want[:p.m]
        assert [s for s, _ in sp.narrows] == list(np.cumsum(
            [0] + [n for _, n in sp.narrows])[:-1])
        # storage (the even split over M) covers the group's columns
        width = params[name].shape[sp.dim] // 16
        for g in range(K):
            cols = [c for r in range(g * p.m, (g + 1) * p.m)
                    for c in range(r * width, (r + 1) * width)]
            assert cols == list(range(g * p.rep * hd, (g + 1) * p.rep * hd))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_and_indivisible_configs_run_whole(arch):
    cfg = get_config(arch).reduced()
    for M in (8, 16):
        plan, _, _ = _plan(cfg, M)
        assert not any(".mixer." in n or ".cross." in n for n in plan), M
    for H, K, M in ((4, 2, 8), (12, 3, 4), (16, 8, 12), (2, 1, 4)):
        assert head_plan(H, K, M).kind == "whole"
    assert head_plan(16, 8, 16) == HeadPlan("kv", 2, 2)
    assert head_plan(56, 8, 16) == HeadPlan("kv", 2, 7)
    assert query_heads(7, 2, 0) == (0, 4) and query_heads(7, 2, 1) == (4, 3)


@pytest.mark.parametrize("arch", ["deepseek_coder_33b", "starcoder2_3b",
                                  "whisper_medium"])
def test_split_leaves_keep_the_reference_specs(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    jm = j_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            max_seq=64))
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key if hasattr(k, "key") else k.idx for k in path]
        if keys[-1] in ("wq", "wk", "wv", "wo") and keys[0] in (
                "blocks", "encoder"):
            spec = J.param_spec(type("Mesh", (), {"shape": M16}),
                                "/".join(map(str, path)), leaf.shape)
            ref[(keys[0], keys[-2], keys[-1])] = tuple(spec)[1:]
    plan, _, specs = _plan(cfg, 16, 16)
    seen = 0
    for name in plan:
        parts = name.split(".")
        if parts[-1] not in ("wq", "wk", "wv", "wo") or parts[2] == "mlp":
            continue
        stack = "encoder" if parts[0] == "encoder" else "blocks"
        assert specs[name] == ref[(stack, parts[2], parts[3])], name
        seen += 1
    assert seen > 0


# ---------------------------------------------------------------------------
# (b), (c) the ranks against the JAX per-step engine
# ---------------------------------------------------------------------------
def _jax_cfg(kind):
    if kind == "whisper":
        return j_get_config("whisper_medium").reduced()
    return dataclasses.replace(j_zoo_config("transformer", "tiny"),
                               **W.TP_ATTENTION[kind])


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    jcfg, cfg = _jax_cfg(kind), W.tp_attention_config(kind)
    model = j_build_model(jcfg, kernels="reference", param_dtype=jnp.float32)
    tp = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=32,
                        dtype=jnp.float32)
    sd = params_from_jax(jax.tree.map(np.asarray, tp), cfg)
    init, step = j_make_train_step(
        model.loss_fn, j_momentum(0.9), JISGDConfig(n_batches=4, k_sigma=1.0,
                                                    stop=2),
        lr_fn=lambda _: jnp.asarray(LR), donate=False)
    state = init(tp)
    losses, limits, accel = [], [], []
    for b in W.tp_attention_batches(cfg, STEPS):
        state, tp, m = step(state, tp, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        losses.append(float(m["loss"]))
        limits.append(float(m["limit"]))
        accel.append(bool(m["accelerated"]))
    return sd, losses, limits, accel, params_from_jax(
        jax.tree.map(np.asarray, tp), cfg)


def _start(tmp_path_factory, kind):
    path = str(tmp_path_factory.mktemp("sd") / f"{kind}.npz")
    np.savez(path, **{k: v.numpy() for k, v in _jax_run(kind)[0].items()})
    return path


# (kind, data, model) of the KV-group legs: even and uneven on (1, 4),
# and uneven with FSDP over data = 2 on (2, 4)
KV_LEGS = [("even", 1, 4), ("uneven", 1, 4), ("uneven", 2, 4)]


@pytest.fixture(scope="module")
def kv_ranks(tmp_path_factory):
    """The KV-group legs (``KV_LEGS``): one spawn each."""
    return {(kind, data, model): spawn_ranks(
        W.tp_attention_rank, data * model, _start(tmp_path_factory, kind),
        kind, model, STEPS, LR, device="cpu", timeout=TIMEOUT)
        for kind, data, model in KV_LEGS}


@pytest.fixture(scope="module")
def whisper_ranks(tmp_path_factory):
    """The whisper (1, 2) leg, a spawn of its own."""
    return spawn_ranks(W.tp_attention_rank, 2,
                       _start(tmp_path_factory, "whisper"), "whisper", 2,
                       STEPS, LR, device="cpu", timeout=TIMEOUT)


def _matches_jax(kind, ranks):
    _, losses, limits, accel, final = _jax_run(kind)
    for got_l, got_lim, got_acc, full, _, _, restored in ranks:
        assert restored                 # full -> load_full: the same shards
        np.testing.assert_allclose(got_l, losses, rtol=2e-5)
        np.testing.assert_allclose(got_lim[1:], limits[1:], rtol=2e-5)
        assert got_acc == accel
        for k, v in final.items():
            want = v.numpy()
            tol = 2e-4 * max(float(np.max(np.abs(want))), 1e-6)
            assert float(np.max(np.abs(full[k] - want))) <= tol, k
    for r in ranks[1:]:                          # every rank: the same bits
        for a, b in zip(ranks[0][3].values(), r[3].values()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,data,model", KV_LEGS,
                         ids=[f"{k}-{d}x{m}" for k, d, m in KV_LEGS])
def test_kv_groups_match_jax_per_step(kind, data, model, kv_ranks):
    ranks = kv_ranks[(kind, data, model)]
    _matches_jax(kind, ranks)
    cfg = W.tp_attention_config(kind)
    H, K, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    for r_id, r in enumerate(ranks):
        split, moved = r[4], r[5]
        _, n, _, _ = rank_heads(H, K, model, r_id % model)
        for i in range(cfg.num_layers):
            pre = f"layers.{i}.mixer."
            # compute: the rank's query heads and its one KV head
            assert split[pre + "wq"][0] == (d, n * hd)
            assert split[pre + "wo"][0] == (n * hd, d)
            assert split[pre + "wk"][0] == split[pre + "wv"][0] == (d, hd)
            # storage: the even split of the spec, rows over data too
            assert split[pre + "wq"][1] == (d // data, H * hd // model)
            assert split[pre + "wk"][1] == (d // data, K * hd // model)
            # narrowed: the query leaves; the KV head is computed whole
            assert split[pre + "wq"][2] is not None
            assert split[pre + "wk"][2] is None
        assert moved > 0
    if kind == "uneven":
        # 3 heads a group over 2 ranks: compute 2 and 1, storage 1.5 each
        assert [r[4]["layers.0.mixer.wq"][0][1] // hd for r in ranks] == \
            [2, 1, 2, 1] * data


def test_whisper_encoder_and_cross_split_on_two_ranks_match_jax(
        whisper_ranks):
    _matches_jax("whisper", whisper_ranks)
    cfg = W.tp_attention_config("whisper")
    hd = cfg.head_dim
    for r in whisper_ranks:
        split = r[4]
        for pre in ("encoder.0.mixer.", "encoder.1.mixer.",
                    "layers.0.mixer.", "layers.0.cross.", "layers.1.cross."):
            assert split[pre + "wq"][0][1] == cfg.num_heads // 2 * hd, pre
            assert split[pre + "wk"][0][1] == cfg.num_kv_heads // 2 * hd, pre
            assert split[pre + "wq"][2] is None      # by heads: no narrowing


def test_fused_engine_with_kv_groups_equals_per_step():
    """The wide tiny transformer (H 4, K 2) on ``(1, 4)``, KV groups of
    two ranks: the fused engine (its CPU loop, K = 4, trips firing)
    against the per-step one, logs and whole params bit for bit."""
    ranks = spawn_ranks(W.tp_fused_rank, 4, 4, 8, 4, device="cpu",
                        timeout=TIMEOUT)
    for (ref, ref_p), (got, got_p) in ranks:
        for k in ("loss", "limit", "psi_bar", "accelerated", "sub_iters"):
            np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
        assert ref["accelerated"].sum() > 0
        for a, b in zip(ref_p, got_p):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_axis_sum_is_the_gather_forms_rank_order_sum(world):
    """The model-axis sum as a reduce-scatter then a gather gives, on
    every rank, each element's f32 rank-order sum of the ranks' values
    cast once: the bits of gathering every rank's tensor and adding them,
    for f32 and bf16 and sizes that the ranks do not divide."""
    ranks = spawn_ranks(W.axis_sum_rank, world, 5, device="cpu",
                        timeout=TIMEOUT)
    dtypes = [torch.float32] * 3 + [torch.bfloat16] * 3
    for i, dtype in enumerate(dtypes):
        xs = [torch.from_numpy(x).to(dtype) for x in ranks[0][i][0]]
        want = xs[0].to(torch.float32)
        for x in xs[1:]:
            want = want + x.to(torch.float32)
        want = want.to(dtype).to(torch.float32).numpy()
        for r in ranks:
            np.testing.assert_array_equal(r[i][1], want)


# ---------------------------------------------------------------------------
# (d) the non-causal chunked backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rep,sq,sk", [(1, 64, 48), (3, 48, 64)],
                         ids=["mha-64x48", "rep3-48x64"])
def test_noncausal_chunked_backward_matches_jax_vjp(rep, sq, sk,
                                                    monkeypatch):
    rng = np.random.RandomState(7)
    B, K, hd = 2, 2, 32
    q = rng.randn(B, sq, K * rep, hd).astype(np.float32)
    k = rng.randn(B, sk, K, hd).astype(np.float32)
    v = rng.randn(B, sk, K, hd).astype(np.float32)
    g = rng.randn(B, sq, K * rep, hd).astype(np.float32)
    ref_out, vjp = jax.vjp(lambda a, b, c: JL._attend_chunked(
        a, b, c, causal=False, window=None), q, k, v)
    ref = vjp(jnp.asarray(g))
    monkeypatch.setattr(L, "Q_CHUNK", 16)          # several chunks a call
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = L._attend_chunked(*ins, causal=False, window=None)
    assert out.grad_fn.name().endswith("_ChunkedAttendBackward")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=0, atol=2e-5 * float(
                                   np.abs(ref_out).max()))
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * float(np.abs(b).max()),
                                   err_msg=f"d{name}")
    # the forward is the plain loop's, bit for bit
    with torch.no_grad():
        plain = L._attend_chunked(*ins, causal=False, window=None)
    np.testing.assert_array_equal(out.detach().numpy(), plain.numpy())


# ---------------------------------------------------------------------------
# (e) the train_4k dry-run on the meta device
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_world():
    """Destroy the fake group a test made (``make_production_mesh``)."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["deepseek_coder_33b", "whisper_medium",
                                  "deepseek_v2_lite_16b"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
def test_train_4k_fits_the_card_on_the_production_meshes(arch, multi_pod,
                                                         fake_world):
    from repro_torch.analysis.roofline import H100_SXM
    from repro_torch.launch import dryrun as D
    cfg, shape, mesh = D._pair(arch, "train_4k", multi_pod, "feature",
                               "full", True)
    mem = {}
    for k in (1, 2):
        cfg_k, n_blocks = D._cfg_with_blocks(cfg, k)
        c, _ = D.count_step(D.build_step(D._meta_model(cfg_k), mesh, shape))
        mem[k] = c.arg_bytes + c.buffer_bytes + c.temp_peak
    gb = (mem[1] + (n_blocks - 1) * (mem[2] - mem[1])) / 1e9
    assert 0 < gb <= H100_SXM["hbm_bytes"] / 1e9, gb
