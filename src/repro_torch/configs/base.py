"""Model config: the fields and properties the dense transformer and the
Mamba2/SSD (``ssm``) families use.

A copy of that subset of ``repro.configs.base.ModelConfig`` (the port
imports nothing of ``repro``). ``param_count`` counts the same parameters
as the JAX package's analytic count for a dense or an ssm config.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # 'dense' | 'ssm' in the port so far
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

    # --- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    conv_width: int = 4

    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (as the JAX package pads)."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def block_size(self) -> int:
        """Layers per repeating block: 1 for the dense and ssm families."""
        return 1

    def _is_attn_layer(self, i: int) -> bool:
        return self.family != "ssm"

    def _attn_params(self) -> int:
        d = self.d_model
        return (d * self.num_heads * self.head_dim
                + 2 * d * self.num_kv_heads * self.head_dim
                + self.num_heads * self.head_dim * d)

    def _ssm_params(self) -> int:
        di, ds, nh = self.d_inner, self.ssm_state, self.ssm_nheads
        d = self.d_model
        in_proj = d * (2 * di + 2 * self.ssm_ngroups * ds + nh)
        conv = self.conv_width * (di + 2 * self.ssm_ngroups * ds)
        out = di * d
        return in_proj + conv + out + 2 * nh + di        # A, D, norm

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once), the JAX
        package's count: a mixer, a SwiGLU MLP of ``d_ff`` (none when 0)
        and 4·d of norms per layer."""
        d = self.d_model
        n = self.padded_vocab * d
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        for i in range(self.num_layers):
            mixer = (self._attn_params() if self._is_attn_layer(i)
                     else self._ssm_params())
            n += mixer + 3 * d * self.d_ff + 4 * d
        return n
