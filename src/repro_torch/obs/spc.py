"""Live SPC control-chart export, the paper's Fig. 3 view, rebuilt at the
host-sync flush points and reconciled bit for bit with the engine.

Port of ``repro.obs.spc``. The exporter keeps a **host-side float32
mirror** of the engine's ``LossQueue`` and replays the arithmetic of
``core.control.push`` / ``push_at`` (same op order, IEEE-754 single
precision) on the per-step losses fetched at chunk/log boundaries. Both
sides do the same sequence of f32 adds and multiplies, so the mirror's
ring buffer (the per-batch ψ table), Σ, Σ², count and ring index match the
device queue **bit for bit**; :meth:`SPCExporter.reconcile` checks it
against the final engine state. That holds only while ``core/control.py``
squares with the same 12/12-bit split as :func:`_sq` and adds in the same
order as :meth:`SPCExporter._push`: change neither side alone.

Accelerate decisions are never recomputed: ``accelerated``/``sub_iters``
come from the engine's own metrics, so the exported accelerate events sum
exactly to ``state.accel_count`` / ``state.sub_iters``. Chart statistics
(ψ̄, limit) are also the engine's; the mirror only owns the table.

The engine state is the per-step ``ISGDState`` (Python-int counters, the
queue on the device) or the fused engine's ``DeviceISGDState`` (every
counter a device tensor): :func:`engine_snapshot` brings its queue and
counters to the host in one transfer.

Two modes mirror the two queue write disciplines:

* ``fifo`` — FCPR engines (``control.push``): window = one epoch, the slot
  a loss lands in is the ring index;
* ``table`` — per-batch table writes (``control.push_at``): one entry per
  batch, slot = the batch index.
"""
from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional

import numpy as np
import torch

_F32 = np.float32


def _f32(x) -> np.float32:
    return _F32(np.asarray(x, dtype=_F32))


def _sq(x: np.float32) -> np.float32:
    """Mirror of ``control._sq``: x² via the exact 12/12-bit split.

    hi/lo and all partial products are ≤24-bit values, exact in Python's
    double arithmetic, so only the two adds round, through ``np.float32``
    in the device's association order. Kept off numpy scalar ops (≈6 µs a
    call of boxing): it runs once per push on the ingestion path."""
    xf = float(_F32(x))
    hi_bits = struct.unpack("<I", struct.pack("<f", xf))[0] & 0xFFFFF000
    hi = struct.unpack("<f", struct.pack("<I", hi_bits))[0]
    lo = xf - hi
    s1 = _F32(hi * hi + 2.0 * (hi * lo))
    return _F32(float(s1) + lo * lo)


class EngineSnapshot(NamedTuple):
    """An engine state's queue and counters, on the host."""
    buf: np.ndarray              # (n_b,) f32
    total: np.float32
    total_sq: np.float32
    count: int
    idx: int
    iter: int
    accel_count: int
    sub_iters: int


_COUNTERS = ("iter", "accel_count", "sub_iters")


def engine_snapshot(state) -> EngineSnapshot:
    """The queue (``buf``, ``total``, ``total_sq``, ``count``, ``idx``) and
    the counters of an ``ISGDState`` or ``DeviceISGDState``, fetched in ONE
    device-to-host transfer: every tensor goes as its 32-bit pattern (f32
    reinterpreted as int32) into one int32 vector. Python-int counters (the
    per-step state's) are taken as they are. A snapshot is returned as it
    is."""
    if isinstance(state, EngineSnapshot):
        return state
    q = state.queue
    n = q.buf.shape[0]
    parts = [q.buf.reshape(-1).view(torch.int32),
             q.total.reshape(1).view(torch.int32),
             q.total_sq.reshape(1).view(torch.int32),
             q.count.reshape(1).to(torch.int32),
             q.idx.reshape(1).to(torch.int32)]
    on_device = [c for c in _COUNTERS if torch.is_tensor(getattr(state, c))]
    parts += [getattr(state, c).reshape(1).to(torch.int32) for c in on_device]
    host = torch.cat(parts).cpu().numpy()
    f32 = host[:n + 2].view(_F32)
    counters = {c: int(getattr(state, c)) for c in _COUNTERS
                if c not in on_device}
    counters.update({c: int(v) for c, v in zip(on_device, host[n + 4:])})
    return EngineSnapshot(buf=f32[:n].copy(), total=f32[n], total_sq=f32[n + 1],
                          count=int(host[n + 2]), idx=int(host[n + 3]),
                          **counters)


class SPCExporter:
    """Replays the SPC queue on host and emits control-chart records."""

    def __init__(self, n_batches: int, k_sigma: float = 3.0, *,
                 mode: str = "fifo", recorder=None, emit_steps: bool = True):
        if mode not in ("fifo", "table"):
            raise ValueError(f"mode must be fifo|table, got {mode!r}")
        self.n_batches = int(n_batches)
        self.k_sigma = float(k_sigma)
        self.mode = mode
        self.recorder = recorder
        self.emit_steps = emit_steps
        # -- exact f32 mirror of control.LossQueue
        self.buf = np.zeros(self.n_batches, dtype=_F32)
        self.buf_sq = np.zeros(self.n_batches, dtype=_F32)  # _sq(buf) cache
        self.total = _F32(0.0)
        self.total_sq = _F32(0.0)
        self.count = 0
        self.idx = 0
        # -- engine-reported accounting
        self.steps = 0
        self.accel_count = 0
        self.sub_iters = 0
        self.events: List[dict] = []

    # ------------------------------------------------ queue replay (exact)

    def _push(self, loss: np.float32) -> int:
        """Mirror of control.push: same op order as the torch version."""
        slot = self.idx
        old = self.buf[slot]
        full = self.count >= self.n_batches
        dec = old if full else _F32(0.0)
        dec_sq = self.buf_sq[slot] if full else _F32(0.0)
        loss_sq = _sq(loss)
        self.total = _F32(_F32(self.total + loss) - dec)
        self.total_sq = _F32(_F32(self.total_sq + loss_sq) - dec_sq)
        self.buf[slot] = loss
        self.buf_sq[slot] = loss_sq
        self.count = min(self.count + 1, self.n_batches)
        self.idx = (slot + 1) % self.n_batches
        return slot

    def _push_at(self, slot: int, loss: np.float32) -> int:
        """Mirror of control.push_at (per-batch table re-keying)."""
        old = self.buf[slot]
        filled = slot < self.count
        dec = old if filled else _F32(0.0)
        dec_sq = self.buf_sq[slot] if filled else _F32(0.0)
        loss_sq = _sq(loss)
        self.total = _F32(_F32(self.total + loss) - dec)
        self.total_sq = _F32(_F32(self.total_sq + loss_sq) - dec_sq)
        self.buf[slot] = loss
        self.buf_sq[slot] = loss_sq
        self.count = min(max(self.count, slot + 1), self.n_batches)
        self.idx = (slot + 1) % self.n_batches
        return slot

    # --------------------------------------------------------- ingestion

    def ingest(self, step: int, metrics: dict, *, batch: Optional[int] = None) -> None:
        """Feed one step's host metrics (loss, psi_bar, limit, accelerated,
        sub_iters [, the batch index via ``batch``])."""
        loss = _f32(metrics["loss"])
        if self.mode == "table":
            if batch is None:
                raise ValueError("table-mode SPC export needs the batch index")
            slot = self._push_at(int(batch), loss)
        else:
            slot = self._push(loss)
        self.steps += 1

        accelerated = bool(np.asarray(metrics["accelerated"]))
        sub = int(np.asarray(metrics["sub_iters"]))
        psi_bar = float(np.asarray(metrics["psi_bar"]))
        limit = float(np.asarray(metrics["limit"]))
        batch_id = int(batch) if batch is not None else slot

        if self.recorder is not None and self.emit_steps:
            self.recorder.event(
                "spc.step", step=int(step), batch=batch_id, psi=float(loss),
                psi_bar=psi_bar, limit=limit, accelerated=accelerated,
                sub_iters=sub)
        if accelerated:
            self.accel_count += 1
            self.sub_iters += sub
            ev = {"step": int(step), "batch": batch_id, "sub_iters": sub,
                  "psi_before": float(loss), "limit": limit,
                  "psi_bar_after": psi_bar}
            self.events.append(ev)
            if self.recorder is not None:
                self.recorder.event("spc.accelerate", **ev)

    # ----------------------------------------------------------- export

    def psi_table(self) -> np.ndarray:
        return self.buf.copy()

    def chart_payload(self) -> dict:
        """The Fig. 3 snapshot: per-batch ψ table + window statistics."""
        count = max(self.count, 1)
        psi_bar = float(_F32(self.total / _F32(count)))
        warm = self.count >= self.n_batches
        valid = self.buf[:self.count].astype(np.float64)
        std = float(np.sqrt(max(((valid - psi_bar) ** 2).sum() / count, 0.0))) \
            if self.count else 0.0
        return {
            "mode": self.mode,
            "n_batches": self.n_batches,
            "k_sigma": self.k_sigma,
            "steps": self.steps,
            "psi_table": [float(x) for x in self.buf],
            "count": self.count,
            "idx": self.idx,
            "total": float(self.total),
            "total_sq": float(self.total_sq),
            "psi_bar": psi_bar,
            "limit": (psi_bar + self.k_sigma * std) if warm else float("inf"),
            "accel_count": self.accel_count,
            "sub_iters": self.sub_iters,
            "accel_events": len(self.events),
        }

    # -------------------------------------------------------- reconcile

    def reconcile(self, state, *, replay_exact: bool = True) -> dict:
        """Check the mirror against the final engine state (an
        ``ISGDState``, a ``DeviceISGDState`` or their ``engine_snapshot``).

        Bit-exact contract (``replay_exact=True``): the ψ table, Σ, Σ² (f32
        bit patterns), count and idx match the engine's queue, and
        steps/accel_count/sub_iters its counters. ``replay_exact=False``
        (a replay whose record order is not the queue's push order) checks
        the counters only.

        Returns ``{"reconciled": bool, "mismatches": [...]}``."""
        snap = engine_snapshot(state)
        mism: List[str] = []

        def _chk(name, got, want):
            if got != want:
                mism.append(f"{name}: export={got} engine={want}")

        _chk("steps", self.steps, snap.iter)
        _chk("accel_count", self.accel_count, snap.accel_count)
        _chk("sub_iters", self.sub_iters, snap.sub_iters)
        _chk("accel_events", len(self.events), snap.accel_count)

        if replay_exact:
            _chk("count", self.count, snap.count)
            _chk("idx", self.idx, snap.idx)
            if self.buf.tobytes() != snap.buf.tobytes():
                bad = int((self.buf.view(np.uint32)
                           != snap.buf.view(np.uint32)).sum())
                mism.append(f"psi_table: {bad}/{self.n_batches} slots differ bitwise")
            for name, mine, theirs in (("total", self.total, snap.total),
                                       ("total_sq", self.total_sq, snap.total_sq)):
                if _f32(mine).tobytes() != _f32(theirs).tobytes():
                    mism.append(f"{name}: export={float(mine)!r} "
                                f"engine={float(theirs)!r}")
        return {"reconciled": not mism, "mismatches": mism,
                "replay_exact": replay_exact}
