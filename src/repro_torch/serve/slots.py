"""Preallocated slot-based KV/state cache for continuous batching.

Port of ``repro.serve.slots``. The decode batch is ``max_batch`` *slots*,
allocated once at ``max_seq`` length. Each slot holds one in-flight
request: its per-layer KV (or SSM conv/state) rows, a per-slot position
cursor ``t``, an ``active`` flag and the last emitted token. Requests
*join* (``admit``) and *leave* (``retire``) between decode steps:

  * ``admit`` prefills one request (B=1 exact-length prefill, no padding,
    so SSM recurrent state is exact) and writes the prefill cache into the
    slot's rows of the static buffers, in place;
  * ``decode`` runs one step over all ``max_batch`` slots with per-slot
    cursors (a cursor vector through ``transformer.decode_step``);
  * ``retire`` clears the active flag; the slot's cache rows are left as
    garbage. This is safe: a retired slot's cursor is parked (``t`` only
    advances for active slots), attention masks every position ``> t``,
    the decode write lands *before* the attend so a re-admitted tenant
    overwrites stale rows as its cursor reaches them, and an SSM admit
    replaces the recurrent state rows wholesale.

**The decode graph.** The reference compiles the decode once for the
engine's lifetime. On a CUDA device the port's counterpart is one CUDA
graph of the decode step: the first decode runs eagerly (the warm-up),
then the step is captured, and every later decode replays it. The graph
holds the addresses of the static buffers (the cache, the cursors,
``active``, ``cur_tok``, the last logits) and of the model's parameters,
so everything that changes them writes in place: ``admit`` and
``retire`` index into the buffers, and ``swap_params`` copies the new
weights into the live parameter tensors (rebinding them, as the
reference rebinds its pytree, would leave the graph reading the old
weights). ``compile_counts()["decode"]`` counts captures and stays 1
across admits, retires and swaps. On the CPU the same step runs eagerly;
there ``decode`` counts the distinct shape and dtype signatures of the
step's state, as the reference's jit cache does. ``prefill`` counts
distinct prompt lengths and ``admit`` distinct (prefill cache, slot
cache) signatures, as the reference's jit caches key them.

A cursor must stay below ``max_seq``: an out-of-range indexed write is a
device-side assert on the card (JAX clamps it); ``admit`` checks on the
host that the prompt fits and the scheduler's token budget keeps every
cursor in range.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.engine import load_params

UNSERVABLE_FAMILIES = ("encdec", "vlm", "audio", "cnn")


def _write_slot(buf, new, batch_axis: int, slot: int):
    """Write a single-request cache tensor into its slot's rows, in place:
    ``new`` has batch size 1 and (where it has one) a sequence axis of at
    most ``max_seq``, written from position 0."""
    idx = tuple(slice(slot, slot + 1) if i == batch_axis
                else slice(0, new.shape[i]) for i in range(buf.dim()))
    buf[idx].copy_(new)
    return buf


@torch.no_grad()
def admit_cache(cache, pre_caches, slot: int):
    """Write one request's prefill caches into slot ``slot``, in place.
    ``prefix`` entries carry the batch at axis 0, the stacked ``blocks``
    entries at axis 1 (axis 0 is ``n_blocks``). Returns the cache."""
    prefix_new, blocks_new = pre_caches
    for be, ne in zip(cache["prefix"], prefix_new):
        for b, n in zip(be, ne):
            _write_slot(b, n, 0, slot)
    for be, ne in zip(cache["blocks"], blocks_new):
        for b, n in zip(be, ne):
            _write_slot(b, n, 1, slot)
    return cache


def _leaves(cache) -> list:
    return ([t for e in cache["prefix"] for t in e]
            + [t for e in cache["blocks"] for t in e])


def _sig(tensors, ptrs: bool = False) -> tuple:
    return tuple((tuple(t.shape), t.dtype) + ((t.data_ptr(),) if ptrs else ())
                 for t in tensors)


class SlotKV:
    """Slot-based serving state and its entry points.

    Device state: the slot cache (per-slot ``t`` cursors, int64),
    ``active`` flags, ``cur_tok`` (each slot's last emitted token, the next
    decode input) and ``logits`` (the last decode's (max_batch, Vp) f32
    logits). Host-side, the scheduler owns which request occupies which
    slot. ``params`` (optional, in ``model.params()`` order) is copied into
    the model first.
    """

    def __init__(self, model, params=None, *, max_batch: int, max_seq: int):
        if model.cfg.family in UNSERVABLE_FAMILIES:
            raise ValueError(
                f"slot-based serving supports decoder-only families, not "
                f"{model.cfg.family!r} (shared-position frontends don't "
                f"compose with per-slot cursors)")
        self.model = model
        load_params(model, params)
        self.params = model.params()
        self.device = self.params[0].device
        self.max_batch = max_batch
        self.max_seq = max_seq
        cache = model.init_cache(max_batch, max_seq)
        cache["t"] = torch.zeros(max_batch, dtype=torch.int64,
                                 device=self.device)        # per-slot cursors
        self.cache = cache
        self.active = torch.zeros(max_batch, dtype=torch.bool, device=self.device)
        self.cur_tok = torch.zeros(max_batch, dtype=torch.int32,
                                   device=self.device)
        self.logits = torch.zeros(max_batch, model.cfg.padded_vocab,
                                  dtype=torch.float32, device=self.device)
        self._graph = None
        self._graph_key = None
        self._captures = 0
        self._decode_sigs: set = set()
        self._admit_sigs: set = set()
        self._prefill_lens: set = set()
        self._retired = False

    def tensors(self) -> list:
        """Every static state tensor: the cache leaves, the cursors,
        ``active``, ``cur_tok`` and ``logits`` (what the decode graph reads
        and writes besides the parameters)."""
        return _leaves(self.cache) + [self.cache["t"], self.active,
                                      self.cur_tok, self.logits]

    # -- request lifecycle --------------------------------------------------
    def prefill(self, prompt: np.ndarray):
        """B=1 exact-length prefill -> (first greedy token, pre_caches)."""
        self._prefill_lens.add(len(prompt))
        tokens = torch.as_tensor(np.asarray(prompt)).to(self.device)[None, :]
        logits, pre = self.model.prefill_fn({"tokens": tokens})
        tok = int(torch.argmax(logits[0, :self.model.cfg.vocab_size]))
        return tok, pre

    def admit(self, slot: int, prompt: np.ndarray) -> int:
        """Prefill ``prompt`` and install it in ``slot``; returns the first
        generated token (the prompt's greedy continuation)."""
        if len(prompt) >= self.max_seq:        # its cursor would be past it
            raise ValueError(f"prompt of {len(prompt)} tokens does not fit "
                             f"max_seq {self.max_seq}")
        tok, pre = self.prefill(prompt)
        self._admit_sigs.add(_sig(_leaves({"prefix": pre[0], "blocks": pre[1]})
                                  + _leaves(self.cache)))
        with torch.no_grad():
            admit_cache(self.cache, pre, slot)
            self.cache["t"][slot] = len(prompt)
            self.active[slot] = True
            self.cur_tok[slot] = tok
        return tok

    def retire(self, slot: int) -> None:
        self._retired = True
        with torch.no_grad():
            self.active[slot] = False

    def _step(self) -> None:
        """The decode step on the static buffers: logits, the next token of
        every active slot, cursors advanced for active slots only (retired
        slots are parked: their write lands at the frozen cursor)."""
        t_prev = self.cache["t"]
        logits, cache = self.model.decode_fn(self.cache, self.cur_tok[:, None])
        nxt = torch.argmax(logits[:, :self.model.cfg.vocab_size], dim=-1)
        with torch.no_grad():
            t_prev.copy_(torch.where(self.active, t_prev + 1, t_prev))
            self.cur_tok.copy_(torch.where(self.active, nxt.to(torch.int32),
                                           self.cur_tok))
            self.logits.copy_(logits)
        cache["t"] = t_prev
        self.cache = cache

    def decode(self, eager: bool = False) -> np.ndarray:
        """One decode step over all slots -> (max_batch,) next tokens
        (host). Retired slots return their frozen last token. On a CUDA
        device it replays the decode graph (captured after the first,
        eager, decode); ``eager=True`` runs the same step without the
        graph."""
        key = _sig(self.tensors(), ptrs=True)
        self._decode_sigs.add(_sig(self.tensors()))
        if not eager and self._graph is not None and key == self._graph_key:
            self._graph.replay()
        else:
            self._step()
            if (not eager and self.device.type == "cuda"
                    and _sig(self.tensors(), ptrs=True) == key):
                self._capture()
        return self.cur_tok.cpu().numpy()

    def _capture(self) -> None:
        """Capture one decode step into a CUDA graph. A capture records the
        step's kernels without running them, so the state is that of the
        eager decode before it."""
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step()
        torch.cuda.synchronize(self.device)
        self._graph, self._graph_key = graph, _sig(self.tensors(), ptrs=True)
        self._captures += 1

    def cursor(self, slot: int) -> int:
        return int(self.cache["t"][slot])

    # -- hot snapshot swap ---------------------------------------------------
    def swap_params(self, params) -> None:
        """Swap the served weights between decode steps: ``params`` (in
        ``model.params()`` order) must match the served shapes and dtypes
        (same config and precision) and is copied into the live parameter
        tensors, so the decode graph reads the new weights. In-flight KV is
        untouched."""
        load_params(self.model, params)

    # -- introspection -------------------------------------------------------
    def compile_counts(self) -> dict:
        """``decode``: graph captures on a CUDA device, distinct step
        signatures on the CPU (stays 1 for the engine's lifetime);
        ``admit`` and ``prefill`` grow with distinct, not total, prompt
        lengths; ``retire`` is 1 once a slot has been retired."""
        cuda = self.device.type == "cuda"
        return {"decode": self._captures if cuda else len(self._decode_sigs),
                "admit": len(self._admit_sigs),
                "prefill": len(self._prefill_lens),
                "retire": int(self._retired)}
