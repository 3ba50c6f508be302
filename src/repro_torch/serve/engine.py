"""Batched serving engine: prefill -> KV cache -> greedy decode loop.

Port of ``repro.serve.engine``. The prefill pass emits per-layer cache
entries sized to the prompt; they are written into the preallocated
``max_seq`` cache buffers (the reference's rule: the first axis whose size
differs is the sequence axis; SSM conv/state entries match exactly and
are copied through). The engine runs eagerly, on the model's plain paths.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.api import frontend_embeds


def _merge_entry(buf, new):
    """Write a prefill cache tensor into its preallocated buffer, in place,
    from position 0 of the first axis whose size differs."""
    if buf.shape == new.shape:
        return buf.copy_(new)
    assert buf.dim() == new.dim(), (tuple(buf.shape), tuple(new.shape))
    axis = next(i for i, (a, b) in enumerate(zip(buf.shape, new.shape))
                if a != b)
    buf.narrow(axis, 0, new.shape[axis]).copy_(new)
    return buf


@torch.no_grad()
def merge_prefill_cache(cache, prefill_caches):
    """cache: from ``model.init_cache``; prefill_caches: (prefix, blocks).
    The buffers are filled in place; returns the cache."""
    prefix_new, blocks_new = prefill_caches
    prefix = [tuple(_merge_entry(b, n) for b, n in zip(be, ne))
              for be, ne in zip(cache["prefix"], prefix_new)]
    blocks = tuple(tuple(_merge_entry(b, n) for b, n in zip(be, ne))
                   for be, ne in zip(cache["blocks"], blocks_new))
    return {"prefix": prefix, "blocks": blocks, "t": cache["t"]}


def load_params(model, params) -> None:
    """Copy ``params`` (a list in ``model.params()`` order) into the
    model's own tensors, after the reference's shape and dtype check; the
    model's tensors are what every serving path reads."""
    live = model.params()
    if params is None or params is live:
        return
    params = list(params)
    if ([(tuple(p.shape), p.dtype) for p in live]
            != [(tuple(p.shape), p.dtype) for p in params]):
        raise ValueError("snapshot params do not match the served "
                         "model's shapes/dtypes")
    with torch.no_grad():
        for dst, src in zip(live, params):
            dst.copy_(src)


class ServeEngine:
    """One-shot generation: the whole batch prefilled together, then
    decoded until every row has its tokens. ``params`` (optional, in
    ``model.params()`` order) is copied into the model first."""

    def __init__(self, model, params=None, *, max_seq: int):
        self.model = model
        load_params(model, params)
        self.params = model.params()
        self.max_seq = max_seq
        self.device = self.params[0].device

    def generate(self, prompts: np.ndarray, steps: int) -> np.ndarray:
        """prompts: (B, Sp) int32 -> (B, Sp+steps) greedy continuation.

        ``steps=0`` returns the prompt unchanged; ``steps=1`` exactly one
        token (the prefill argmax): the prefill token counts toward
        ``steps``, it is not a freebie on top.
        """
        B, Sp = prompts.shape
        if Sp + steps > self.max_seq:          # a cursor past the cache
            raise ValueError(f"prompt {Sp} + steps {steps} exceeds max_seq "
                             f"{self.max_seq}")
        if steps == 0:
            return np.asarray(prompts).copy()
        vocab = self.model.cfg.vocab_size
        batch = {"tokens": torch.as_tensor(np.asarray(prompts)).to(self.device)}
        fe = frontend_embeds(self.model.cfg, B, self.device)
        if fe is not None:
            batch["frontend_embeds"] = fe
        logits, pre = self.model.prefill_fn(batch)
        cache = merge_prefill_cache(self.model.init_cache(B, self.max_seq), pre)
        cache["t"] = Sp
        toks = [torch.argmax(logits[:, :vocab], -1)]
        for _ in range(steps - 1):
            logits, cache = self.model.decode_fn(
                cache, toks[-1][:, None].to(torch.int32))
            toks.append(torch.argmax(logits[:, :vocab], -1))
        gen = torch.stack(toks, dim=1).cpu().numpy().astype(prompts.dtype)
        return np.concatenate([prompts, gen], axis=1)
