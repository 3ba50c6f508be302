"""Fixed-Cycle Pseudo-Random (FCPR) sampling, the paper's §3.4.

A numpy copy of ``repro.data.fcpr.FCPRSampler`` and ``ExplicitBatches``
(that module cannot be imported without jax). It draws from
``np.random.RandomState`` in the same order, so for the same seed the two
samplers give identical batches.

The dataset is permuted once and sliced into ``n_batches`` batches;
iteration ``j`` takes batch ``j mod n_batches``, a fixed ring, which is what
gives the ISGD loss queue its "one window = one epoch" meaning.
"""
from __future__ import annotations

import warnings
from typing import Dict

import numpy as np


class FCPRSampler:
    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, shuffle_quality: float = 1.0):
        n = len(next(iter(arrays.values())))
        for v in arrays.values():
            if len(v) != n:
                raise ValueError("FCPRSampler arrays differ in length")
        self.n_data = n
        self.batch_size = batch_size
        self.n_batches = n // batch_size
        if self.n_batches <= 0:
            raise ValueError(f"batch_size {batch_size} exceeds the {n} rows")
        self.n_dropped = n - self.n_batches * batch_size
        if self.n_dropped:
            warnings.warn(
                f"FCPRSampler drops {self.n_dropped} of {n} rows "
                f"(n_data mod batch_size != 0); pad the dataset or pick a "
                f"divisor batch size to train on every row", stacklevel=2)
        rng = np.random.RandomState(seed)
        perm = np.arange(n)
        if shuffle_quality >= 1.0:
            rng.shuffle(perm)
        elif shuffle_quality > 0.0:
            k = int(n * shuffle_quality)
            idx = rng.choice(n, size=k, replace=False)
            sub = perm[idx].copy()
            rng.shuffle(sub)
            perm[idx] = sub
        usable = self.n_batches * batch_size
        self.arrays = {k: np.ascontiguousarray(v[perm[:usable]])
                       for k, v in arrays.items()}

    def batch_index(self, j: int) -> int:
        """t = j mod (n_d / n_b), the paper's fixed cycle."""
        return j % self.n_batches

    def epoch_arrays(self) -> Dict[str, np.ndarray]:
        """The whole permuted epoch (``n_batches * batch_size`` rows per
        key) as C-contiguous arrays; batch t is rows [t*bs, (t+1)*bs). What
        a ``DeviceRing`` uploads, once."""
        return self.arrays

    def epoch_nbytes(self) -> int:
        """Host bytes of one permuted epoch (the ring's byte-budget check)."""
        return sum(v.nbytes for v in self.arrays.values())

    def __call__(self, j: int) -> Dict[str, np.ndarray]:
        """Batch ``t = j mod n_b`` as contiguous leading-axis views."""
        t = self.batch_index(j)
        lo, hi = t * self.batch_size, (t + 1) * self.batch_size
        return {k: v[lo:hi] for k, v in self.arrays.items()}


class ExplicitBatches:
    """Pre-built batches cycled in fixed order (the Fig.1 controlled
    experiments: single-class and i.i.d. batches)."""

    def __init__(self, batches):
        self.batches = list(batches)
        self.n_batches = len(self.batches)
        self.batch_size = len(next(iter(self.batches[0].values())))

    def batch_index(self, j: int) -> int:
        return j % self.n_batches

    def epoch_arrays(self) -> Dict[str, np.ndarray]:
        """The concatenated fixed cycle (batch t = rows [t*bs, (t+1)*bs)),
        so a ``DeviceRing`` can take explicit batches too."""
        keys = self.batches[0].keys()
        return {k: np.ascontiguousarray(
                    np.concatenate([np.asarray(b[k]) for b in self.batches]))
                for k in keys}

    def epoch_nbytes(self) -> int:
        return sum(np.asarray(v).nbytes
                   for b in self.batches for v in b.values())

    def __call__(self, j: int):
        return self.batches[self.batch_index(j)]
