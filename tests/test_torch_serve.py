"""Port vs JAX: serving's prefill and cached decode, on the CPU.

  * ``prefill_fn`` logits and caches, and every ``decode_fn`` step's
    logits, against the JAX ``prefill_fn``/``decode_fn`` with the same
    params (``repro_torch.convert``) on reduced InternLM2 (GQA), Mamba2
    (SSM), Gemma3 (sliding window with global layers), DeepSeek-V2-Lite
    (MLA, dense prefix, shared experts) and Jamba (hybrid SSM/attention
    with MoE), in f32 (``close_f32``: 1e-5 relative, elementwise and to
    the tensor's largest magnitude) and, but for Jamba, in bf16
    (``close_bf16``: the reference's own 3e-2 for prefill and 5e-2 for
    decode, ``tests/test_serve.py``, taken relative in norm: XLA
    evaluates a fused chain of bf16 elementwise ops in f32 and rounds
    once where PyTorch rounds after each op, so single elements sit one
    bf16 step at the residual's magnitude apart, 0.016–0.063 a layer on
    reduced Jamba, while the tensors agree within 1.6 % in norm); Jamba's
    eight bf16 layers move its MoE router inputs by those steps and its
    top-k gaps are as small as 5.7e-4, so the two frameworks route some
    token differently (14 % apart in norm): it is compared in f32, with
    every routing decision asserted clear of a tie;
    whisper (enc-dec) and InternVL2 (VLM) through the one-shot engine,
    logits and tokens. The f32 comparison
    decodes from f32 caches (``init_cache(dtype=f32)`` on both sides):
    the engines' caches are bf16 whatever the model's dtype, and the
    decode attend casts its probabilities to the cache's dtype, so with
    them a 1e-6 difference upstream can move a value across a bf16
    rounding boundary (one bf16 step, 2⁻⁸ relative) and the logits by up
    to about 2e-3 (seen on Gemma3); the bf16-cache path is held at the
    bf16 tolerance and by the engines' token checks;
  * ``moe_decode`` against JAX with capacity drops (16 slots, 4 experts,
    capacity factor 1.25: C = 10 of 32 slot-expert pairs);
  * the reference's invariants in the port: prefill plus decode
    reproduces the full forward, f32 greedy argmax equals the full
    forward's at every position, a cursor vector equals a scalar cursor,
    the ``steps=0``/``steps=1`` contract, sliding-window cache decode.

Each test draws its inputs with numpy from a seed; the JAX side runs its
plain paths (its serving has no Pallas kernel).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import zoo_config as j_zoo_config
from repro.models import build_model as j_build_model
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serve import ServeEngine as JServeEngine
from repro.serve import merge_prefill_cache as j_merge
from repro_torch.configs import get_config, zoo_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine, merge_prefill_cache
from test_torch_moe import MARGIN, routing_margin

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
MAX_SEQ = 32
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = {"prefill": dict(rtol=3e-2, atol=3e-2),   # port vs full forward
            "decode": dict(rtol=5e-2, atol=5e-2)}
BF16_JAX = {"prefill": 3e-2, "decode": 5e-2}   # port vs JAX: relative, norm
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def pair(cfg, jcfg, dtype="f32", max_seq=MAX_SEQ, seed=0):
    """The JAX model and params, and the port's model carrying the same
    params, in ``dtype``."""
    jd, td = DTYPES[dtype]
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg, max_seq=max_seq,
                        dtype=jd)
    jm = j_build_model(jcfg, param_dtype=jd)
    m = build_model(cfg, kernels="reference", param_dtype=td, device="cpu")
    m.init(0, max_seq=max_seq)
    m.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp),
                                             cfg))
    return jm, jp, m


def arch_pair(arch, dtype="f32", max_seq=MAX_SEQ):
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    return (cfg,) + pair(cfg, jcfg, dtype, max_seq)


def zoo_pair(family, dtype="f32", max_seq=48):
    cfg, jcfg = zoo_config(family, "tiny"), j_zoo_config(family, "tiny")
    return (cfg,) + pair(cfg, jcfg, dtype, max_seq)


def f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def leaves(caches) -> list:
    prefix, blocks = caches
    return [t for e in prefix for t in e] + [t for e in blocks for t in e]


def close_f32(a, b):
    """|a − b| ≤ 1e-5·|b| + 1e-5·max|b|."""
    b = f32(b)
    np.testing.assert_allclose(f32(a), b, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(b).max()), 1.0))


def close_bf16(a, b, tol):
    """‖a − b‖ ≤ tol·‖b‖ (Frobenius)."""
    a, b = f32(a), f32(b)
    err = float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-30)
    assert err <= tol, err


def close(a, b, dtype, phase):
    if dtype == "f32":
        close_f32(a, b)
    else:
        close_bf16(a, b, BF16_JAX[phase])


def caches(jm, m, B, S, jpre, pre, dtype):
    """Both sides' decode caches, the prefill merged in: the engines'
    (bf16) for bf16, f32 ones for f32."""
    if dtype == "bf16":
        return (j_merge(jm.init_cache(B, S), jpre),
                merge_prefill_cache(m.init_cache(B, S), pre))
    return (j_merge(JT.init_cache(jm.cfg, B, S, dtype=jnp.float32), jpre),
            merge_prefill_cache(T.init_cache(m.cfg, B, S, device="cpu",
                                             dtype=torch.float32), pre))


def frontend(cfg, B):
    if cfg.family == "vlm":
        return np.zeros((B, cfg.num_image_tokens, cfg.d_model), np.float32)
    if cfg.family == "encdec":
        return np.zeros((B, cfg.encoder_seq, cfg.d_model), np.float32)
    return None


ARCHS = ["internlm2_1_8b", "mamba2_2_7b", "gemma3_12b",
         "deepseek_v2_lite_16b", "jamba_v0_1_52b"]


@pytest.mark.parametrize("arch,dtype", [(a, "f32") for a in ARCHS]
                         + [(a, "bf16") for a in ARCHS[:-1]])
def test_prefill_and_decode_match_jax(arch, dtype, monkeypatch):
    cfg, jm, jp, m = arch_pair(arch, dtype)
    B, Sp, S = 2, 8, 16
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    gaps = routing_margin(monkeypatch)
    jlog, jpre = jax.jit(jm.prefill_fn)(jp, {"tokens": jnp.asarray(tokens[:, :Sp])})
    log, pre = m.prefill_fn({"tokens": torch.from_numpy(tokens[:, :Sp])})
    close(log, jlog, dtype, "prefill")
    assert len(leaves(pre)) == len(leaves(jpre))
    for a, b in zip(leaves(pre), leaves(jpre)):
        assert tuple(a.shape) == b.shape
        close(a, b, dtype, "prefill")

    jcache, cache = caches(jm, m, B, S, jpre, pre, dtype)
    jcache["t"] = jnp.asarray(Sp, jnp.int32)
    cache["t"] = Sp
    jdecode = jax.jit(jm.decode_fn)
    for t in range(Sp, S):
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tokens[:, t:t + 1]))
        log, cache = m.decode_fn(cache, torch.from_numpy(tokens[:, t:t + 1]))
        close(log, jlog, dtype, "decode")
    assert cache["t"] == S
    if dtype == "f32":
        assert min(gaps, default=1.0) > MARGIN, gaps
    assert bool(gaps) == bool(cfg.num_experts)


@pytest.mark.parametrize("arch", ["whisper_medium", "internvl2_2b"])
def test_oneshot_frontend_archs_match_jax(arch):
    """Enc-dec and VLM serve through the one-shot engine only: its prefill
    (zero bf16 frontend embeddings, as the engines make them) and decode
    logits, and its tokens, equal the JAX engine's."""
    cfg, jm, jp, m = arch_pair(arch, max_seq=64)
    B, Sp, S = 2, 8, 14
    if cfg.family == "vlm":
        Sp = cfg.num_image_tokens + 4
        S = Sp + 6
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    fe = frontend(cfg, B)
    jbatch = {"tokens": jnp.asarray(tokens[:, :Sp]),
              "frontend_embeds": jnp.asarray(fe, jnp.bfloat16)}
    jlog, jpre = jax.jit(jm.prefill_fn)(jp, jbatch)
    log, pre = m.prefill_fn({"tokens": torch.from_numpy(tokens[:, :Sp]),
                             "frontend_embeds": torch.zeros(
                                 fe.shape, dtype=torch.bfloat16)})
    close_f32(log, jlog)
    for a, b in zip(leaves(pre), leaves(jpre)):
        close_f32(a, b)
    jcache, cache = caches(jm, m, B, S, jpre, pre, "f32")
    jcache["t"] = jnp.asarray(Sp, jnp.int32)
    cache["t"] = Sp
    for t in range(Sp, S):
        jlog, jcache = jm.decode_fn(jp, jcache, jnp.asarray(tokens[:, t:t + 1]))
        log, cache = m.decode_fn(cache, torch.from_numpy(tokens[:, t:t + 1]))
        close_f32(log, jlog)
    prompts = tokens[:, :Sp]
    want = JServeEngine(jm, jp, max_seq=S + 4).generate(prompts, steps=6)
    got = ServeEngine(m, max_seq=S + 4).generate(prompts, steps=6)
    np.testing.assert_array_equal(got, want)
    if cfg.family == "encdec":
        vec = m.init_cache(B, S)
        vec["t"] = torch.full((B,), Sp)
        with pytest.raises(NotImplementedError, match="enc-dec"):
            m.decode_fn(vec, torch.from_numpy(tokens[:, :1]))


def test_moe_decode_matches_jax_with_drops(monkeypatch):
    """16 slots routed as one group over 4 experts at capacity factor
    1.25: C = max(4, min(16, ⌊16·2·1.25/4⌋)) = 10 slots an expert, so
    some (token, expert) pairs drop; outputs and aux equal JAX's within
    1e-5, with every routing decision clear of a tie."""
    cfg = dataclasses.replace(zoo_config("moe", "tiny"),
                              moe_capacity_factor=1.25)
    jcfg = dataclasses.replace(j_zoo_config("moe", "tiny"),
                               moe_capacity_factor=1.25)
    assert M._capacity(16, cfg.top_k, cfg.num_experts, 1.25) == 10
    jp = JM.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    # every token leans towards expert 0, so it gets more than C = 10 of
    # the 32 (token, expert) pairs and the rest drop
    r0 = np.asarray(jp["router"])[:, 0]
    x = (np.random.RandomState(3).randn(16, 1, cfg.d_model)
         + 2.0 * r0 / np.linalg.norm(r0)).astype(np.float32)
    gaps = routing_margin(monkeypatch)
    y, aux = M.moe_decode(p, cfg, torch.from_numpy(x))
    jy, jaux = JM.moe_decode(jp, jcfg, jnp.asarray(x))
    close_f32(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert min(gaps) > MARGIN, gaps
    # drops happened: the top-k choices overflow some expert's capacity
    _, _, idx = M._router(p, torch.from_numpy(x).reshape(1, 16, -1), cfg.top_k)
    per_expert = np.bincount(idx.reshape(-1).numpy(), minlength=cfg.num_experts)
    assert per_expert.max() > 10, per_expert


# ---------------------------------------------------------------------------
# the reference's invariants (tests/test_serve.py), in the port
# ---------------------------------------------------------------------------
def port_arch(arch, dtype=torch.bfloat16, max_seq=MAX_SEQ):
    cfg = get_config(arch).reduced()
    m = build_model(cfg, kernels="reference", param_dtype=dtype, device="cpu")
    m.init(0, max_seq=max_seq)
    return cfg, m


def full_logits(m, tokens):
    h, _ = T.forward(m.module, tokens, remat=False)
    return T.logits_head(m.module, h)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_2_7b",
                                  "gemma3_12b", "deepseek_v2_lite_16b"])
def test_prefill_then_decode_matches_forward(arch):
    cfg, m = port_arch(arch)
    B, Sp, S = 2, 8, 16
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, S)))
    full = full_logits(m, tokens)
    logits, pre = m.prefill_fn({"tokens": tokens[:, :Sp]})
    cache = merge_prefill_cache(m.init_cache(B, S), pre)
    cache["t"] = Sp
    np.testing.assert_allclose(f32(logits), f32(full[:, Sp - 1]),
                               **BF16_TOL["prefill"])
    for t in range(Sp, S):
        logits, cache = m.decode_fn(cache, tokens[:, t:t + 1])
        np.testing.assert_allclose(f32(logits), f32(full[:, t]),
                                   **BF16_TOL["decode"])


@pytest.mark.parametrize("family", ["transformer", "ssm"])
def test_decode_argmax_matches_full_forward(family):
    """f32: prefill plus stepwise cached decode picks the full forward's
    greedy token at every position."""
    cfg = zoo_config(family, "tiny")
    m = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                    device="cpu")
    m.init(0, max_seq=16)
    B, Sp, S = 1, 4, 12
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, S)))
    want = full_logits(m, tokens)[..., :cfg.vocab_size].argmax(-1)
    logits, pre = m.prefill_fn({"tokens": tokens[:, :Sp]})
    cache = merge_prefill_cache(m.init_cache(B, S), pre)
    cache["t"] = Sp
    assert torch.equal(logits[:, :cfg.vocab_size].argmax(-1), want[:, Sp - 1])
    for t in range(Sp, S):
        logits, cache = m.decode_fn(cache, tokens[:, t:t + 1])
        assert torch.equal(logits[:, :cfg.vocab_size].argmax(-1), want[:, t])


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_2_7b",
                                  "gemma3_12b", "deepseek_v2_lite_16b"])
def test_vector_t_decode_matches_scalar(arch):
    """A (B,) cursor vector reproduces the scalar-cursor decode when all
    cursors agree: GQA, SSM, sliding window and MLA cache paths."""
    cfg, m = port_arch(arch)
    B, Sp, S = 2, 6, 16
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, Sp + 1)))
    _, pre = m.prefill_fn({"tokens": tokens[:, :Sp]})

    def decode_with(t):
        cache = merge_prefill_cache(m.init_cache(B, S), pre)
        cache["t"] = t
        return m.decode_fn(cache, tokens[:, -1:])

    logits_s, cache_s = decode_with(Sp)
    logits_v, cache_v = decode_with(torch.full((B,), Sp))
    np.testing.assert_allclose(f32(logits_v), f32(logits_s), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(cache_v["t"], torch.full((B,), Sp + 1))
    for a, b in zip(leaves((cache_v["prefix"], cache_v["blocks"])),
                    leaves((cache_s["prefix"], cache_s["blocks"]))):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-5)


def test_generate_step_counts():
    """steps=0 -> the prompt unchanged; steps=1 -> exactly one token, the
    prefill argmax (it counts toward steps, not on top of them)."""
    cfg = zoo_config("transformer", "tiny")
    m = build_model(cfg, kernels="reference", device="cpu")
    m.init(0, max_seq=32)
    engine = ServeEngine(m, max_seq=32)
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 8)).astype(np.int32)
    np.testing.assert_array_equal(engine.generate(prompts, steps=0), prompts)
    out1 = engine.generate(prompts, steps=1)
    assert out1.shape == (2, 9)
    logits, _ = m.prefill_fn({"tokens": torch.from_numpy(prompts)})
    np.testing.assert_array_equal(
        out1[:, -1], logits[:, :cfg.vocab_size].argmax(-1).numpy())
    full = full_logits(m, torch.from_numpy(prompts))
    out4 = engine.generate(prompts, steps=4)
    assert out4.shape == (2, 12)
    np.testing.assert_array_equal(
        out4[:, 8], full[:, -1, :cfg.vocab_size].argmax(-1).numpy())
    with pytest.raises(ValueError, match="max_seq"):
        engine.generate(prompts, steps=25)          # past max_seq


def test_sliding_window_cache_decode():
    """Gemma3-style local layers: a decode whose window is shorter than
    the context matches the full forward."""
    cfg, m = port_arch("gemma3_12b", max_seq=64)
    B, S = 1, 48
    assert cfg.sliding_window < S
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, S)))
    full = full_logits(m, tokens)
    _, pre = m.prefill_fn({"tokens": tokens[:, :S - 1]})
    cache = merge_prefill_cache(m.init_cache(B, S), pre)
    cache["t"] = S - 1
    logits, _ = m.decode_fn(cache, tokens[:, -1:])
    np.testing.assert_allclose(f32(logits), f32(full[:, -1]),
                               **BF16_TOL["decode"])
