"""Model config: the fields and properties the dense transformer family uses.

A copy of the dense subset of ``repro.configs.base.ModelConfig`` (the port
imports nothing of ``repro``). ``param_count`` counts the same parameters
as the JAX package's analytic count for a dense config.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # only 'dense' in the port so far
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    vocab_size: int = 0
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (as the JAX package pads)."""
        return _round_up(self.vocab_size, 256)

    def block_size(self) -> int:
        """Layers per repeating block: 1 for the dense family."""
        return 1

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d = self.d_model
        n = self.padded_vocab * d
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        attn = (d * self.num_heads * self.head_dim
                + 2 * d * self.num_kv_heads * self.head_dim
                + self.num_heads * self.head_dim * d)
        mlp = 3 * d * self.d_ff
        return n + self.num_layers * (attn + mlp + 4 * d)
