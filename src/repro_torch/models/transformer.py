"""Decoder stack (decoder-only, hybrid, enc-dec, VLM): layer plan,
parameters, forward, head and LM loss.

Port of ``repro.models.transformer``: training's forward and loss, and
serving's ``prefill``, ``init_cache`` and ``decode_step``. The layer pattern of every configuration
is periodic: ``first_dense`` prefix layers, then ``n_blocks`` blocks of
``block_size()`` layers that repeat exactly (``stack_plan`` asserts it).
A layer is a mixer (``attn`` with an optional window, ``mla`` or ``ssm``),
an MLP (``swiglu``, ``gelu2``, ``moe`` or ``none``) and, in an enc-dec
decoder, a cross-attention slot.

The model is an ``nn.Module`` whose weights keep the JAX layout. Its
``state_dict`` names are ``embed``, ``final_norm``, ``head`` (untied only)
and ``layers.{i}.*`` for global layer i (the prefix first, then layer
``first_dense + b·P + p`` of block b): ``ln1``, ``mixer.*`` (attention
``wq, wk, wv, wo``; MLA ``wq, wkv_a, wk_b, wv_b, wo, kv_norm``; SSM
``in_proj, conv_w, conv_b, A_log, D, dt_bias, gnorm, out_proj``), and
where the layer has an MLP ``ln2`` and ``mlp.*`` (SwiGLU ``wg, wi, wo``;
GELU ``wi, wo``; MoE ``router, wg, wi, wo`` and ``swg, swi, swo`` with
shared experts), and in an enc-dec decoder ``ln_x`` and ``cross.{wq, wk,
wv, wo}``. An enc-dec model adds ``encoder.{j}.*`` (attention and GELU
layers), ``enc_final_norm``, ``enc_pos`` and ``pos_embed``
(``repro_torch.convert`` maps them to and from the JAX tree).

``remat`` recomputes each decoder layer in the backward pass
(``torch.utils.checkpoint``, one layer per checkpoint; the JAX package
checkpoints one block of ``block_size()`` layers, the same values). So
under ``kernels="cuda"`` each attention layer's ``gqa_flash`` and each SSM
layer's ``ssd_scan`` run twice per loss-and-gradient: in the forward and
in the recomputation. MLA, cross attention and the encoder run the plain
``_attend_chunked`` in either mode, as in the JAX package.

Under the hybrid engine's tensor-parallel split
(``repro_torch.distributed.data_parallel``) an attention layer (self or
cross, decoder or whisper encoder) holds its rank's heads
(``wq``/``wk``/``wv`` by columns, ``wo`` by rows; the head plan of
``launch.shardings``) and a SwiGLU or GELU MLP its rank's ``d_ff`` slice;
the layers read the local widths off the weights and the split
(``sharding.current_tp()``, read once a forward and handed down, so a
recomputed layer sees it too) adds the row-parallel partial sums over the
model ranks. ``constrain`` marks the
reference's activation points: "hidden" after the embedding and after each
layer, "logits" after the head, "decode_hidden" in a decode step.

Serving caches follow the reference's layout: ``{"prefix": [entry per
prefix layer], "blocks": (entry per block position, each tensor stacked
over n_blocks on axis 0), "t": position}``; an entry is ``(k, v)`` (GQA),
``(c_kv, k_rope)`` (MLA) or ``(conv_state, ssd_state)`` (SSM), with the
encoder's ``(ck, cv)`` appended in an enc-dec decoder. ``decode_step``
writes the attention entries in place and copies each new SSM state into
its entry where the dtype agrees, so on a bf16 model a decode step's
inputs and outputs are the same tensors (what a CUDA graph of the step
needs). Serving runs the plain paths whatever the kernel mode, as
``repro.models.api`` serves without ``use_pallas``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.sharding import constrain, current_tp

LOSS_CHUNK = 512
MAX_SEQ = 4096                  # pos_embed rows of an enc-dec model by default


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerSpec:
    mixer: str                   # 'attn' | 'mla' | 'ssm'
    window: Optional[int]
    mlp: str                     # 'swiglu' | 'gelu2' | 'moe' | 'none'
    cross: bool = False


ENCODER_SPEC = LayerSpec("attn", None, "gelu2")


def _mixer_for(cfg, i: int) -> tuple:
    if cfg.family == "ssm":
        return "ssm", None
    if cfg.family == "hybrid" and cfg.attn_every and not cfg._is_attn_layer(i):
        return "ssm", None
    if cfg.mla:
        return "mla", None
    window = cfg.sliding_window
    if cfg.global_every and i % cfg.global_every == cfg.global_every - 1:
        window = None                       # the block's last layer is global
    return "attn", window


def _mlp_for(cfg, i: int) -> str:
    if cfg._is_moe_layer(i):
        return "moe"
    if cfg.d_ff == 0:
        return "none"                       # mamba2: mixer-only layers
    return "gelu2" if cfg.family == "encdec" else "swiglu"


def layer_spec(cfg, i: int) -> LayerSpec:
    mixer, window = _mixer_for(cfg, i)
    return LayerSpec(mixer, window, _mlp_for(cfg, i),
                     cross=cfg.family == "encdec")


def stack_plan(cfg):
    """-> (prefix_specs, block_specs, n_blocks)."""
    prefix = [layer_spec(cfg, i) for i in range(cfg.first_dense)]
    P = cfg.block_size()
    rest = cfg.num_layers - cfg.first_dense
    assert rest % P == 0, (cfg.name, rest, P)
    n_blocks = rest // P
    block = [layer_spec(cfg, cfg.first_dense + p) for p in range(P)]
    # the pattern must repeat exactly, as the JAX package's scan needs
    for b in range(1, n_blocks):
        for p in range(P):
            assert layer_spec(cfg, cfg.first_dense + b * P + p) == block[p], \
                (cfg.name, b, p)
    return prefix, block, n_blocks


def layer_specs(cfg) -> list:
    """The spec of every decoder layer, in global order."""
    prefix, block, n_blocks = stack_plan(cfg)
    return prefix + block * n_blocks


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _dense(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _f32(shape, device):
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


def _attn_params(cfg, dtype, device):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": _dense((d, H * hd), dtype, device),
            "wk": _dense((d, K * hd), dtype, device),
            "wv": _dense((d, K * hd), dtype, device),
            "wo": _dense((H * hd, d), dtype, device)}


def _mla_params(cfg, dtype, device):
    d, H = cfg.d_model, cfg.num_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    return {"wq": _dense((d, H * (dn + dr)), dtype, device),
            "wkv_a": _dense((d, r + dr), dtype, device),
            "wk_b": _dense((r, H * dn), dtype, device),
            "wv_b": _dense((r, H * dv), dtype, device),
            "wo": _dense((H * dv, d), dtype, device),
            "kv_norm": _f32((r,), device)}


def _ssm_params(cfg, dtype, device):
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    cch = S.conv_channels(cfg)
    return {"in_proj": _dense((d, 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state
                               + nh), dtype, device),
            "conv_w": _dense((cfg.conv_width, cch), dtype, device),
            "conv_b": _dense((cch,), dtype, device),
            "A_log": _f32((nh,), device),
            "D": _f32((nh,), device),
            "dt_bias": _f32((nh,), device),
            "gnorm": _f32((di,), device),
            "out_proj": _dense((di, d), dtype, device)}


_MIXERS = {"attn": _attn_params, "mla": _mla_params, "ssm": _ssm_params}


def _mlp_params(cfg, kind, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    if kind == "moe":
        return M.init_moe(cfg, dtype, device)
    if kind == "gelu2":
        return {"wi": _dense((d, ff), dtype, device),
                "wo": _dense((ff, d), dtype, device)}
    return {"wg": _dense((d, ff), dtype, device),
            "wi": _dense((d, ff), dtype, device),
            "wo": _dense((ff, d), dtype, device)}


class Layer(nn.Module):
    def __init__(self, cfg, spec: LayerSpec, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.spec = spec
        self.ln1 = _f32((d,), device)
        if spec.mlp != "none":
            self.ln2 = _f32((d,), device)
        self.mixer = nn.ParameterDict(_MIXERS[spec.mixer](cfg, dtype, device))
        if spec.mlp != "none":
            self.mlp = nn.ParameterDict(_mlp_params(cfg, spec.mlp, dtype,
                                                    device))
        if spec.cross:
            self.ln_x = _f32((d,), device)
            self.cross = nn.ParameterDict(_attn_params(cfg, dtype, device))


class Transformer(nn.Module):
    """Parameters of the stack, allocated uninitialized; ``init_params``
    fills them (and allocates an enc-dec model's ``pos_embed``, whose rows
    it sizes)."""

    def __init__(self, cfg, *, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        Vp, d = cfg.padded_vocab, cfg.d_model
        self.cfg = cfg
        self.embed = _dense((Vp, d), dtype, device)
        self.final_norm = _f32((d,), device)
        self.head = None if cfg.tie_embeddings else _dense((d, Vp), dtype, device)
        self.layers = nn.ModuleList(Layer(cfg, spec, dtype, device)
                                    for spec in layer_specs(cfg))
        if cfg.family == "encdec":
            self.encoder = nn.ModuleList(
                Layer(cfg, ENCODER_SPEC, dtype, device)
                for _ in range(cfg.encoder_layers))
            self.enc_final_norm = _f32((d,), device)
            self.enc_pos = _dense((cfg.encoder_seq, d), dtype, device)


@torch.no_grad()
def init_params(model: Transformer, seed: int = 0,
                max_seq: int = MAX_SEQ) -> Transformer:
    """Fill ``model`` from a ``torch.Generator`` seeded with ``seed`` on the
    model's device: weights of two or more dims (the MoE router too) normal
    · 1/√(shape[-2]) (drawn in f32, then cast), norm scales and biases
    zero, and the SSM leaves as ``init_ssm`` sets them: ``A_log =
    log(linspace(1, 16, nh))``, ``D = 1``, ``dt_bias = log(expm1(0.01))``.
    An enc-dec model's ``pos_embed`` is allocated here with ``max(max_seq,
    1)`` rows, as the JAX ``init_params`` sizes it. The random
    draws are not the JAX package's (tests carry JAX weights over with
    ``repro_torch.convert``). On the meta device it only allocates."""
    dev = model.embed.device
    if model.cfg.family == "encdec":
        model.pos_embed = _dense((max(max_seq, 1), model.cfg.d_model),
                                 model.embed.dtype, dev)
    if dev.type == "meta":        # shapes only (the dry-run): nothing to draw
        return model
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if p.dim() < 2:
            p.zero_()
            continue
        w = torch.randn(p.shape, generator=gen, dtype=torch.float32, device=dev)
        p.copy_(w * (1.0 / math.sqrt(p.shape[-2])))
    for layer in model.layers:
        if layer.spec.mixer == "ssm":
            m = layer.mixer
            nh = m["A_log"].shape[0]
            m["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, nh,
                                                      dtype=torch.float32)))
            m["D"].fill_(1.0)
            m["dt_bias"].copy_(torch.log(torch.expm1(
                torch.full((nh,), 0.01, dtype=torch.float32))))
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _apply_mlp(layer: Layer, cfg, h, decode: bool = False, tp=None):
    """-> (y, aux); aux is 0.0 but for an MoE layer (``moe_decode`` for
    one decode token a row). A dense MLP holding a ``d_ff`` slice runs
    tensor-parallel over ``tp`` (module doc)."""
    kind = layer.spec.mlp
    if kind == "moe":
        return (M.moe_decode if decode else M.moe_forward)(layer.mlp, cfg, h)
    split = tp is not None and layer.mlp["wi"].shape[1] < cfg.d_ff
    if split:
        h = tp.copy_in(h)
    if kind == "gelu2":
        y = L.gelu(h @ layer.mlp["wi"]) @ layer.mlp["wo"]
    else:
        y = L.mlp(layer.mlp, h)
    return (tp.reduce_out(y) if split else y), 0.0


def apply_layer(layer: Layer, cfg, x, positions, enc_out=None,
                use_kernels: bool = False, want_cache: bool = False,
                tp=None):
    """One decoder layer over the full sequence -> (x, aux), or with
    ``want_cache`` (x, cache entry, aux). ``use_kernels`` routes an
    ``attn`` mixer through ``gqa_flash`` and an ``ssm`` mixer through
    ``ssd_chunked_kernel``; otherwise, and for MLA, the plain paths run.
    ``tp``: the tensor-parallel split of the evaluation (module doc)."""
    spec = layer.spec
    h = L.rms_norm(x, layer.ln1, cfg.norm_eps)
    if spec.mixer == "attn":
        o = L.attn_forward(layer.mixer, cfg, h, positions, window=spec.window,
                           use_rope=cfg.family != "encdec",
                           use_kernel=use_kernels, want_cache=want_cache,
                           tp=tp)
    elif spec.mixer == "mla":
        o = L.mla_forward(layer.mixer, cfg, h, positions,
                          want_cache=want_cache)
    else:
        o = S.ssm_forward(layer.mixer, cfg, h, use_kernel=use_kernels,
                          want_cache=want_cache)
    cache = ()
    if want_cache:
        o, cache = o
    x = x + o
    if spec.cross:
        hx = L.rms_norm(x, layer.ln_x, cfg.norm_eps)
        x = x + L.cross_attn_forward(layer.cross, cfg, hx, enc_out, tp)
        if want_cache:
            cache = cache + L.cross_kv(layer.cross, cfg, enc_out)
    aux = 0.0
    if spec.mlp != "none":
        y, aux = _apply_mlp(layer, cfg, L.rms_norm(x, layer.ln2, cfg.norm_eps),
                            tp=tp)
        x = x + y
    x = constrain(x, "hidden")
    return (x, cache, aux) if want_cache else (x, aux)


def apply_layer_decode(layer: Layer, cfg, x, cache, t):
    """One decode token a row through one layer. x: (B, 1, d); ``cache``
    this layer's entry; ``t`` an int or a (B,) cursor tensor. -> (x, new
    entry, aux): attention entries are the given tensors, written in
    place; SSM states are new tensors."""
    spec = layer.spec
    h = L.rms_norm(x, layer.ln1, cfg.norm_eps)
    if spec.mixer == "attn":
        o, ck, cv = L.attn_decode(layer.mixer, cfg, h, cache[0], cache[1], t,
                                  window=spec.window,
                                  use_rope=cfg.family != "encdec")
        new = (ck, cv) + tuple(cache[2:])
    elif spec.mixer == "mla":
        o, ckv, krope = L.mla_decode(layer.mixer, cfg, h, cache[0], cache[1], t)
        new = (ckv, krope)
    else:
        o, conv, ssd = S.ssm_decode(layer.mixer, cfg, h, cache[0], cache[1])
        new = (conv, ssd)
    x = x + o
    if spec.cross:
        hx = L.rms_norm(x, layer.ln_x, cfg.norm_eps)
        x = x + L.cross_attn_decode(layer.cross, cfg, hx, cache[2], cache[3])
    if spec.mlp == "none":
        return x, new, 0.0
    y, aux = _apply_mlp(layer, cfg, L.rms_norm(x, layer.ln2, cfg.norm_eps),
                        decode=True)
    return x + y, new, aux


def encoder_forward(model: Transformer, frames, tp=None):
    """Whisper encoder. frames: (B, Se, d) stub embeddings -> (B, Se, d);
    ``enc_pos`` added, non-causal plain attention without RoPE (the
    self-attention form of ``cross_attn_forward``), GELU MLPs. ``tp``:
    the tensor-parallel split, by heads and ``d_ff`` as in the decoder
    (module doc)."""
    cfg = model.cfg
    x = frames + model.enc_pos[None, :frames.shape[1]]
    for lp in model.encoder:
        h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
        x = x + L.cross_attn_forward(lp.mixer, cfg, h, h, tp)
        y, _ = _apply_mlp(lp, cfg, L.rms_norm(x, lp.ln2, cfg.norm_eps), tp=tp)
        x = x + y
    return L.rms_norm(x, model.enc_final_norm, cfg.norm_eps)


def _embed(model: Transformer, tokens, frontend_embeds=None):
    """Token embeddings; a VLM's frontend embeddings overwrite the first
    ``n`` positions, an enc-dec model adds ``pos_embed[:S]``."""
    cfg = model.cfg
    x = F.embedding(tokens.long(), model.embed)
    if cfg.family == "vlm" and frontend_embeds is not None:
        n = frontend_embeds.shape[1]
        x = torch.cat([frontend_embeds.to(x.dtype), x[:, n:]], dim=1)
    if cfg.family == "encdec":
        x = x + model.pos_embed[None, :tokens.shape[1]]
    return constrain(x, "hidden")


def _shard(tp, x):
    return x if tp is None else tp.shard(x)


def _unshard(tp, x):
    return x if tp is None else tp.unshard(x)


def _apply_layer_sharded(layer: Layer, cfg, xs, positions, enc_out,
                         use_kernels, tp):
    """``apply_layer`` from and to the rank's slice of the hidden stream
    (``tp.unshard``, ``tp.shard``; the whole stream where there is no
    split): what a checkpointed layer saves is its input's slice."""
    x, aux = apply_layer(layer, cfg, _unshard(tp, xs), positions, enc_out,
                         use_kernels, False, tp)
    return _shard(tp, x), aux


def forward(model: Transformer, tokens, frontend_embeds=None, *, remat=True,
            use_kernels=False, want_cache=False):
    """tokens (B, S) -> (final hidden (B, S, d), aux summed over layers),
    or with ``want_cache`` (hidden, (prefix_caches, block_caches), aux) in
    the reference's stacking (``stack_caches``).

    Under a tensor-parallel split a checkpointed stack carries the hidden
    stream between its layers as the rank's 1/M of d, as the reference's
    "hidden" rule places it (``(batch, seq, "model")``): each layer
    gathers its input's slices in rank order, exactly, and hands on its
    output's slice (``TensorParallel.shard``), so the checkpoints hold 1/M
    of the stream where they held it whole on every model rank. The bits
    are the whole stream's: every model rank computes the same values."""
    cfg = model.cfg
    tp = current_tp()
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    enc_out = None
    if cfg.family == "encdec":
        enc_out = encoder_forward(model, frontend_embeds, tp)
    x = _embed(model, tokens, frontend_embeds)
    remat = remat and torch.is_grad_enabled() and not want_cache
    if remat:
        x = _shard(tp, x)
    aux_total, caches = 0.0, []
    for layer in model.layers:
        if want_cache:
            x, cache, aux = apply_layer(layer, cfg, x, positions, enc_out,
                                        use_kernels, want_cache=True, tp=tp)
            caches.append(cache)
        elif remat:
            x, aux = checkpoint(_apply_layer_sharded, layer, cfg, x,
                                positions, enc_out, use_kernels, tp,
                                use_reentrant=False)
        else:
            x, aux = apply_layer(layer, cfg, x, positions, enc_out,
                                 use_kernels, tp=tp)
        aux_total = aux_total + aux
    if remat:
        x = _unshard(tp, x)
    h = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    if want_cache:
        return h, stack_caches(cfg, caches), aux_total
    return h, aux_total


def stack_caches(cfg, entries: list):
    """Per-layer cache entries in global order -> ``(prefix, blocks)``:
    the prefix layers' entries as they are, and for block position p a
    tuple of tensors stacked over the n_blocks layers ``first_dense + b·P
    + p`` (axis 0)."""
    prefix, block, n_blocks = stack_plan(cfg)
    f, P = len(prefix), len(block)
    blocks = tuple(
        tuple(torch.stack([entries[f + b * P + p][e] for b in range(n_blocks)])
              for e in range(len(entries[f + p])))
        for p in range(P))
    return list(entries[:f]), blocks


def head_weight(model: Transformer):
    """The (d, Vp) output projection: a transposed view of the embedding
    when tied (no copy), the ``head`` parameter otherwise."""
    return model.embed.T if model.cfg.tie_embeddings else model.head


def logits_head(model: Transformer, h):
    cfg = model.cfg
    logits = (h @ head_weight(model)).to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        col = torch.arange(cfg.padded_vocab, device=h.device)
        logits = torch.where(col < cfg.vocab_size, logits,
                             torch.full_like(logits, -1e30))
    return constrain(logits, "logits")


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def chunked_xent(model: Transformer, h, labels, mask):
    """The ``--kernels reference`` loss. h: (B,S,d); labels/mask: (B,S).
    Returns (sum_nll, sum_mask) in f32."""
    S = h.shape[1]
    c = min(LOSS_CHUNK, S)
    while S % c:                  # largest dividing chunk <= requested
        c -= 1
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        logits = logits_head(model, h[:, sl])                 # (B,c,Vp) f32
        lse = torch.logsumexp(logits, dim=-1)
        col = torch.arange(logits.shape[-1], device=h.device)
        gold = torch.sum(torch.where(col == labels[:, sl, None], logits,
                                     torch.zeros_like(logits)), dim=-1)
        mc = mask[:, sl]
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot, cnt


def lm_loss_fn(model: Transformer, batch, *, aux_weight=0.01, remat=True,
               use_kernels=False):
    """Next-token cross-entropy averaged over valid positions.

    Labels are the tokens rolled left by one, the last position masked (and
    a VLM's image positions). ``batch`` holds ``tokens`` and, for a VLM or
    an enc-dec model, ``frontend_embeds``. Returns f32 ``(total_loss,
    data_loss)``: total = data + ``aux_weight`` · the MoE layers' summed
    aux (total is data where there is no MoE layer). ψ is total."""
    cfg = model.cfg
    tokens = batch["tokens"]
    h, aux = forward(model, tokens, batch.get("frontend_embeds"), remat=remat,
                     use_kernels=use_kernels)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).to(torch.int32)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if cfg.family == "vlm":
        mask[:, :cfg.num_image_tokens] = 0.0
    if use_kernels:
        from repro_torch.kernels.fused_xent import fused_xent_sum
        tot, cnt = fused_xent_sum(h, head_weight(model), labels, mask,
                                  cfg.vocab_size)
    else:
        tot, cnt = chunked_xent(model, h, labels, mask)
    loss = (tot / torch.clamp(cnt, min=1.0)).to(torch.float32)
    if not torch.is_tensor(aux):
        return loss, loss
    return loss + aux_weight * aux.to(torch.float32), loss


# ---------------------------------------------------------------------------
# serving: cache, prefill, decode
# ---------------------------------------------------------------------------
def init_cache(cfg, B: int, S: int, *, device, dtype=torch.bfloat16) -> dict:
    """Zero caches for every layer, bf16 whatever the model's dtype (the
    SSD state f32), as the reference's ``init_cache``; ``t`` = 0."""
    prefix_specs, block_specs, n_blocks = stack_plan(cfg)
    K, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def entry(sp: LayerSpec, lead: tuple):
        if sp.mixer == "attn":
            e = (zeros(*lead, B, S, K, hd), zeros(*lead, B, S, K, hd))
        elif sp.mixer == "mla":
            e = (zeros(*lead, B, S, cfg.kv_lora_rank),
                 zeros(*lead, B, S, cfg.qk_rope_head_dim))
        else:
            e = (zeros(*lead, B, cfg.conv_width - 1, S_conv(cfg)),
                 zeros(*lead, B, cfg.ssm_nheads, cfg.ssm_headdim,
                       cfg.ssm_state, dt=torch.float32))
        if sp.cross:
            e = e + (zeros(*lead, B, cfg.encoder_seq, K, hd),
                     zeros(*lead, B, cfg.encoder_seq, K, hd))
        return e

    return {"prefix": [entry(sp, ()) for sp in prefix_specs],
            "blocks": tuple(entry(sp, (n_blocks,)) for sp in block_specs),
            "t": 0}


def S_conv(cfg) -> int:
    """The SSM conv channels (``init_cache``'s ``S`` is the cache length)."""
    return S.conv_channels(cfg)


def _kept(buf, new):
    """The cache entry after a decode produced ``new`` for ``buf``: ``buf``
    itself when ``new`` is its memory (written in place) or fits it
    (copied in); ``new`` when its dtype differs (a bf16 conv state that an
    f32 model's decode promoted), as the reference's functional cache
    changes dtype."""
    if new.dtype != buf.dtype:
        return new
    if new.data_ptr() != buf.data_ptr():
        buf.copy_(new)
    return buf


def _kept_stacked(buf, news: list):
    """``_kept`` for a block entry stacked over n_blocks: ``news`` holds
    each block's value."""
    if any(n.dtype != buf.dtype for n in news):
        return torch.stack(news)
    for b, n in enumerate(news):
        _kept(buf[b], n)
    return buf


@torch.no_grad()
def decode_step(model: Transformer, cache: dict, tokens):
    """One decode step. tokens: (B, 1) -> (logits (B, Vp) f32, cache).

    ``cache["t"]`` is an int (one-shot serving: every row at the same
    position) or a (B,) tensor of per-row cursors (continuous batching,
    ``repro_torch.serve.slots``); the returned cache holds ``t + 1``.
    Enc-dec configs take only an int (their learned position embedding
    and cross attention assume one shared position)."""
    cfg = model.cfg
    prefix_specs, block_specs, n_blocks = stack_plan(cfg)
    t = cache["t"]
    if L._is_vector(t) and cfg.family == "encdec":
        raise NotImplementedError(
            "per-slot decode cursors are not supported for enc-dec configs "
            "(learned pos_embed lookup + cross-attention assume one shared "
            "position)")
    x = F.embedding(tokens.long(), model.embed)
    if cfg.family == "encdec":
        t0 = int(t)
        x = x + model.pos_embed[None, t0:t0 + 1]
    x = constrain(x, "decode_hidden")
    f, P = len(prefix_specs), len(block_specs)
    prefix = []
    for i, ce in enumerate(cache["prefix"]):
        x, new, _ = apply_layer_decode(model.layers[i], cfg, x, ce, t)
        prefix.append(tuple(_kept(b, n) for b, n in zip(ce, new)))
    outs = [[None] * n_blocks for _ in range(P)]
    for b in range(n_blocks):
        for p in range(P):
            ce = tuple(e[b] for e in cache["blocks"][p])
            x, outs[p][b], _ = apply_layer_decode(
                model.layers[f + b * P + p], cfg, x, ce, t)
    blocks = tuple(
        tuple(_kept_stacked(buf, [outs[p][b][e] for b in range(n_blocks)])
              for e, buf in enumerate(stacked))
        for p, stacked in enumerate(cache["blocks"]))
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = logits_head(model, x)[:, 0]
    return logits, {"prefix": prefix, "blocks": blocks, "t": t + 1}


@torch.no_grad()
def prefill(model: Transformer, tokens, frontend_embeds=None):
    """Full-sequence prefill on the plain paths -> (last-token logits (B,
    Vp) f32, (prefix_caches, block_caches))."""
    h, caches, _ = forward(model, tokens, frontend_embeds, remat=False,
                           use_kernels=False, want_cache=True)
    return logits_head(model, h[:, -1:])[:, 0], caches
