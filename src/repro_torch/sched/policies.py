"""Batch-selection policies implementing the ``BatchSchedule`` protocol.

Port of ``repro.sched.policies``. Each policy is a frozen dataclass of
static hyper-parameters (the reference's fields and defaults); its methods
work on a dict of tensors on the training device:

  * ``init(n_batches, device) -> state``
  * ``select(state, step, key) -> (batch_idx, state)``
  * ``update(state, batch_idx, loss) -> state``

``select`` and ``update`` read nothing back to the host, so the fused
engine captures them into its CUDA graph with the rest of the step.

Policies:

  * :class:`FCPRSchedule` — the paper's §3.4 fixed cycle ``t = j mod n_b``;
    its ``update`` is the identity and it ignores the key, so an engine
    threading it is bit-exact with the unscheduled engines.
  * :class:`LossPropSchedule` — loss-proportional sampling at batch
    granularity (Katharopoulos & Fleuret, 2017): batch i with probability
    ``(1-ε)·s_i/Σs + ε/n_b``, ``s`` the min-shifted EMA loss table, so no
    batch falls below ``ε/n_b`` a draw.
  * :class:`RankSchedule` — Loshchilov & Hutter (2015): p(rank r) ∝
    ``exp(-r·ln(pressure)/(n_b-1))`` over the table sorted by loss, highest
    first (a stable sort, as ``jnp.argsort``).

Both table policies open with the deterministic sweep ``t = j`` for ``j <
n_b``, so every table slot holds a real loss before sampling starts and
``control.push_at`` fills the SPC queue in slot order.

The draw. The reference draws with ``jax.random.categorical(fold_in(
PRNGKey(seed), j), log p)``, which PyTorch cannot reproduce draw for draw.
Here ``key = fold_in(seed, j)`` is a counter-based hash of ``(seed, j)``
(murmur3's 32-bit finaliser, on int64 tensors whose products stay below
2^48) and the draw is the inverse CDF of ``p`` at ``u = (key >> 8)·2^-24``.
The batch drawn at step j is a pure function of ``(seed, j, table)``: the
same in a fresh process after a resume, in the per-step engine and inside
the fused engine's graph, with no generator whose offset a replay advances.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x · c) mod 2^32`` for int64 ``x`` in [0, 2^32): ``c`` is split
    in 16-bit halves, so no product passes 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _fmix32(h):
    """murmur3's 32-bit finaliser, a bijection of [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fmix32_int(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def fold_in(seed: int, step, device="cuda"):
    """The selection key of step ``step`` (an int or a 0-d int tensor):
    a 0-d int64 tensor in [0, 2^32), a pure function of ``(seed, step)``."""
    j = torch.as_tensor(step, dtype=torch.int64, device=device) & _M32
    return _fmix32(j ^ _fmix32_int(int(seed) & _M32))


def uniform(key):
    """The f32 uniform in [0, 1) of a key: its top 24 bits, exactly."""
    return (key >> 8).to(torch.float32) * (1.0 / (1 << 24))


def categorical(key, p):
    """Index drawn from the probabilities ``p`` (n,) at ``uniform(key)``
    by the inverse CDF; an entry with p = 0 is never drawn. int64, 0-d."""
    cdf = torch.cumsum(p, 0)
    u = uniform(key) * cdf[-1]
    return torch.clamp((cdf <= u).sum(), max=p.shape[0] - 1)


def _step(step, like):
    return torch.as_tensor(step, dtype=torch.int64, device=like.device)


@dataclass(frozen=True)
class FCPRSchedule:
    """Fixed cycle ``t = j mod n_b`` (paper §3.4) as a schedule policy."""

    #: FCPR keeps the FIFO loss queue ("one window = one epoch" holds).
    uses_table = False

    def init(self, n_batches: int, device="cuda"):
        return {"n_b": torch.tensor(n_batches, dtype=torch.int32,
                                    device=device)}

    def select(self, state, step, key):
        del key                           # deterministic: identity from index
        return torch.remainder(_step(step, state["n_b"]), state["n_b"]), state

    def update(self, state, batch_idx, loss):
        return state


@dataclass(frozen=True)
class _TableSchedule:
    """Shared state and update of the table policies: an EMA-smoothed loss
    table and visit counters, swept in FCPR order for one warm-up epoch.
    ``uses_table=True`` tells the scheduled engine to write the SPC queue
    per batch (``control.push_at``) instead of FIFO (``repro_torch.sched``
    package doc)."""

    #: EMA smoothing for the table: ``new = (1-beta)*old + beta*loss``.
    beta: float = 0.5
    #: uniform mixing weight — P(select i) ≥ eps/n_b every post-warm-up draw.
    eps: float = 0.1

    uses_table = True

    def init(self, n_batches: int, device="cuda"):
        return {"table": torch.zeros((n_batches,), dtype=torch.float32,
                                     device=device),
                "visits": torch.zeros((n_batches,), dtype=torch.int32,
                                      device=device)}

    def _scores(self, table):
        raise NotImplementedError

    def select(self, state, step, key):
        table = state["table"]
        n_b = table.shape[0]
        p = self._scores(table)
        p = (1.0 - self.eps) * p + self.eps / n_b
        drawn = categorical(key, p)
        step = _step(step, table)
        # warm-up epoch: deterministic FCPR sweep fills the table in order
        return torch.where(step < n_b, torch.remainder(step, n_b), drawn), state

    def update(self, state, batch_idx, loss):
        table, visits = state["table"], state["visits"]
        i = torch.as_tensor(batch_idx, device=table.device).long().reshape(1)
        loss = torch.as_tensor(loss, dtype=torch.float32, device=table.device)
        old = table.index_select(0, i).reshape(())
        n = visits.index_select(0, i)
        new = torch.where(n.reshape(()) > 0,
                          (1.0 - self.beta) * old + self.beta * loss, loss)
        return {"table": table.index_put((i,), new.reshape(1)),
                "visits": visits.index_put((i,), n + 1)}


@dataclass(frozen=True)
class LossPropSchedule(_TableSchedule):
    """Sample ∝ smoothed per-batch loss (min-shifted so the distribution is
    scale- and offset-robust), ε-uniform mixed."""

    def _scores(self, table):
        n_b = table.shape[0]
        s = table - torch.min(table)
        total = torch.sum(s)
        # all-equal table (e.g. warm-up zeros) -> uniform
        return torch.where(total > 0.0, s / torch.clamp(total, min=1e-30),
                           torch.full_like(s, 1.0 / n_b))


@dataclass(frozen=True)
class RankSchedule(_TableSchedule):
    """Exponential-decay ranking (Loshchilov & Hutter 2015): sort batches by
    table loss descending; the top-ranked batch is ``pressure``× as likely
    as the bottom one."""

    #: selection pressure s_e — p_top / p_bottom.
    pressure: float = 100.0
    eps: float = 0.0                      # exp decay is already > 0 everywhere

    def _scores(self, table):
        n_b = table.shape[0]
        order = torch.argsort(-table, stable=True)      # rank 0 = highest loss
        ranks = torch.zeros_like(order).index_put(
            (order,), torch.arange(n_b, device=table.device))
        # ranks span 0..n_b-1, so the rate divides by n_b-1 to make the
        # realized p_top/p_bottom ``pressure``; f32 arithmetic on the host,
        # as the reference's, since a capture may not copy a host value in
        rate = float(np.log(np.float32(self.pressure))
                     / np.float32(max(n_b - 1, 1)))
        return torch.softmax(-rate * ranks.to(torch.float32), 0)


_FAMILIES = {"fcpr": FCPRSchedule, "loss-prop": LossPropSchedule,
             "rank": RankSchedule}


def schedule_from_spec(spec: str):
    """Parse a ``--schedule`` CLI spec: ``family[:k=v,...]`` — e.g.
    ``"fcpr"``, ``"loss-prop"``, ``"loss-prop:eps=0.2,beta=0.3"``,
    ``"rank:pressure=50"``."""
    family, _, rest = spec.partition(":")
    cls = _FAMILIES.get(family)
    if cls is None:
        raise ValueError(f"unknown schedule {family!r} "
                         f"(choose from {sorted(_FAMILIES)})")
    kwargs = {}
    for kv in filter(None, rest.split(",")):
        k, sep, v = kv.partition("=")
        if not sep:
            raise ValueError(f"malformed schedule option {kv!r} (want k=v)")
        kwargs[k] = float(v)
    return cls(**kwargs)
