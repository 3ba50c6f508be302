"""Model API: ``build_model(cfg, ...)`` -> ``Model``, the surface the
trainer, the launchers and the serving engines use. Port of
``repro.models.api``, for every family the JAX package trains (dense, moe,
ssm, hybrid, encdec, vlm):

  init(seed, max_seq)      -> the module, filled in place
  loss_fn(batch)           -> (total_loss, data_loss)        [train]
  prefill_fn(batch)        -> (last logits, caches)          [serve]
  decode_fn(cache, tokens) -> (logits, cache)                [serve]
  init_cache(B, S)         -> zero caches on the model's device
  input_specs(shape)       -> {name: meta tensor} for train/prefill/decode

``kernels`` picks the mixer and loss implementations at build time:

  * ``"cuda"``: ``gqa_flash`` (GQA attention layers), ``ssd_chunked_kernel``
    (SSM layers) and ``fused_xent_sum``, whose wrappers launch the
    hand-written CUDA kernels on a CUDA device, and compute their plain
    PyTorch versions on a CPU device (the CPU tests run this way). MLA,
    cross attention, the encoder and the MoE dispatch run plain PyTorch in
    both modes, as they run outside any Pallas kernel in the JAX package;
  * ``"reference"``: the model's own plain paths, ``_attend_chunked``,
    ``ssm.ssd_chunked`` and ``chunked_xent``, as the JAX package's
    ``"reference"``.

Nothing is resolved behind the caller's back: the requested mode is the
mode that runs. Serving (``prefill_fn``, ``decode_fn``) runs the plain
paths under either mode, as ``repro/models/api.py`` serves: its prefill
and decode call ``T.prefill``/``T.decode_step`` without ``use_pallas``,
so the JAX package runs no Pallas kernel there either.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import KERNEL_CHOICES
from repro_torch.models import transformer as T


def frontend_embeds(cfg, B: int, device):
    """Zero bf16 frontend embeddings (B, n, d) for a VLM (its image
    tokens) or an enc-dec model (its audio frames), as the reference's
    launchers and serving engine make them; None for the other
    families."""
    if cfg.family == "vlm":
        shape = (B, cfg.num_image_tokens, cfg.d_model)
    elif cfg.family == "encdec":
        shape = (B, cfg.encoder_seq, cfg.d_model)
    else:
        return None
    return torch.zeros(shape, dtype=torch.bfloat16, device=device)


def input_specs(cfg, shape: InputShape) -> dict:
    """The batch of ``shape`` as meta tensors (shapes and dtypes only), as
    the reference's ``input_specs`` gives ``ShapeDtypeStruct``s: int32
    ``tokens`` (B, S), (B, 1) at decode; bf16 ``frontend_embeds`` for a
    VLM (B, image tokens, d) or an enc-dec model (B, encoder_seq, d), not
    at decode."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty(
        (B, 1 if shape.kind == "decode" else S), dtype=torch.int32,
        device="meta")}
    if shape.kind != "decode":
        fe = frontend_embeds(cfg, B, "meta")
        if fe is not None:
            specs["frontend_embeds"] = fe
    return specs


@dataclass
class Model:
    cfg: ModelConfig
    module: T.Transformer
    kernels: str
    init: Callable               # (seed, max_seq) -> module, filled in place
    loss_fn: Callable            # (batch) -> (total_loss, data_loss)
    prefill_fn: Callable         # (batch) -> (last logits, caches)
    decode_fn: Callable          # (cache, tokens (B, 1)) -> (logits, cache)
    init_cache: Callable         # (B, S) -> zero caches

    def params(self) -> list:
        return list(self.module.parameters())

    def input_specs(self, shape: InputShape) -> dict:
        return input_specs(self.cfg, shape)


def build_model(cfg: ModelConfig, *, kernels: str = "cuda",
                param_dtype=torch.bfloat16, remat: bool = True,
                device="cuda") -> Model:
    """``param_dtype`` is the compute dtype of weights and activations
    (bf16 by default); norm scales, the MoE router, ψ and the SPC queue
    stay f32. ``loss_fn(batch)`` reads ``batch["frontend_embeds"]`` for a
    VLM or an enc-dec model. ``init(seed, max_seq)`` sizes an enc-dec
    model's ``pos_embed`` to ``max_seq`` rows, as the JAX ``init`` does."""
    if kernels not in KERNEL_CHOICES:
        raise ValueError(f"kernels must be one of {KERNEL_CHOICES}, "
                         f"got {kernels!r}")
    dev = resolve_device(device)
    module = T.Transformer(cfg, dtype=param_dtype, device=dev)
    use_kernels = kernels == "cuda"

    def init(seed: int = 0, max_seq: int = T.MAX_SEQ):
        return T.init_params(module, seed, max_seq=max_seq)

    def loss_fn(batch):
        return T.lm_loss_fn(module, batch, remat=remat,
                            use_kernels=use_kernels)

    def prefill_fn(batch):
        return T.prefill(module, batch["tokens"], batch.get("frontend_embeds"))

    def decode_fn(cache, tokens):
        return T.decode_step(module, cache, tokens)

    def init_cache(B: int, S: int):
        return T.init_cache(cfg, B, S, device=dev)

    return Model(cfg, module, kernels, init, loss_fn, prefill_fn, decode_fn,
                 init_cache)
