"""Model config: every field, property and method of the JAX package's
``ModelConfig`` that training reads, and the architecture registry.

A copy of ``repro.configs.base`` (the port imports nothing of ``repro``):
the fields of every family (dense, moe, ssm, hybrid, encdec, vlm), the
layer predicates the stack plan reads (``block_size``, ``_is_moe_layer``,
``_is_attn_layer``), the analytic ``param_count`` and ``reduced()``, the
CPU-size variant of the same family. ``ARCH_IDS`` and ``get_config``
resolve the ten assigned architectures against ``repro_torch.configs``;
``InputShape``, ``INPUT_SHAPES``, ``LONG_CONTEXT_ARCHS`` and
``shape_applicable`` are the dry-run matrix (``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
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

    # --- attention variants -------------------------------------------------
    sliding_window: Optional[int] = None   # SWA width (mixtral, gemma3 local)
    global_every: int = 0                  # gemma3: one global layer per block of this size
    mla: bool = False                      # DeepSeek-V2 multi-head latent attention
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                      # per-expert hidden size
    moe_every: int = 1                     # MoE layer every k-th layer
    first_dense: int = 0                   # leading dense layers (deepseek-v2)
    moe_capacity_factor: float = 1.25      # GShard-style capacity (1e9 = no drop)

    # --- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    conv_width: int = 4

    # --- hybrid (jamba) --------------------------------------------------------
    attn_every: int = 0                    # one attention layer per block of this size

    # --- encoder-decoder (whisper) ---------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0                   # audio frame positions (stub frontend)

    # --- modality frontend stub --------------------------------------------------
    frontend: Optional[str] = None         # 'audio' | 'vision': embeddings precomputed
    num_image_tokens: int = 0

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
        """Layers per repeating block (the pattern's period)."""
        if self.family == "hybrid" and self.attn_every:
            return self.attn_every
        if self.global_every:
            return self.global_every
        if self.num_experts and self.moe_every > 1:
            return self.moe_every
        return 1

    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (embedding included once); with
        ``active_only`` each MoE layer counts its top-k and shared experts
        only."""
        d = self.d_model
        n = self.padded_vocab * d
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        for i in range(self.num_layers):
            n += self._layer_params(i, active_only)
        if self.family == "encdec":
            for _ in range(self.encoder_layers):
                n += self._attn_params() + 2 * d * self.d_ff + 4 * d
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla:
            q = d * self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            kv_a = d * (self.kv_lora_rank + self.qk_rope_head_dim)
            kv_b = self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim
                                                         + self.v_head_dim)
            o = self.num_heads * self.v_head_dim * d
            return q + kv_a + kv_b + o
        return (d * self.num_heads * self.head_dim
                + 2 * d * self.num_kv_heads * self.head_dim
                + self.num_heads * self.head_dim * d)

    def _mlp_params(self, i: int) -> int:
        d = self.d_model
        if self.num_experts and self._is_moe_layer(i):
            e = 3 * d * self.moe_d_ff
            return ((self.num_experts + self.num_shared_experts) * e
                    + d * self.num_experts)
        return 3 * d * self.d_ff

    def _mlp_active_params(self, i: int) -> int:
        d = self.d_model
        if self.num_experts and self._is_moe_layer(i):
            e = 3 * d * self.moe_d_ff
            return (self.top_k + self.num_shared_experts) * e + d * self.num_experts
        return 3 * d * self.d_ff

    def _is_moe_layer(self, i: int) -> bool:
        if not self.num_experts or i < self.first_dense:
            return False
        if self.moe_every > 1:       # the last layer of each block
            return i % self.moe_every == self.moe_every - 1
        return True

    def _is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid" and self.attn_every:
            # one attention layer per block, mid-block (jamba: index 4 of 8)
            return i % self.attn_every == self.attn_every // 2
        return True

    def _ssm_params(self) -> int:
        di, ds, nh = self.d_inner, self.ssm_state, self.ssm_nheads
        d = self.d_model
        in_proj = d * (2 * di + 2 * self.ssm_ngroups * ds + nh)
        conv = self.conv_width * (di + 2 * self.ssm_ngroups * ds)
        out = di * d
        return in_proj + conv + out + 2 * nh + di        # A, D, norm

    def _layer_params(self, i: int, active_only: bool) -> int:
        mixer = self._attn_params() if self._is_attn_layer(i) else self._ssm_params()
        mlp = self._mlp_active_params(i) if active_only else self._mlp_params(i)
        if self.family == "encdec":
            mixer += self._attn_params()                 # cross attention
        return mixer + mlp + 4 * self.d_model            # norms

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU-size variant: the same family and layer pattern, tiny dims."""
        d = min(self.d_model, 256)
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, 2))
        blk = self.block_size()
        layers = max(2, blk) if blk > 1 else 2
        kw = dict(
            num_layers=layers,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            num_image_tokens=min(self.num_image_tokens, 8),
        )
        if self.mla:
            kw.update(kv_lora_rank=64, qk_rope_head_dim=16, qk_nope_head_dim=32,
                      v_head_dim=32)
        if self.num_experts:
            # no-drop capacity, as the JAX package's reduced variants
            kw.update(num_experts=min(self.num_experts, 4),
                      top_k=min(self.top_k, 2),
                      moe_d_ff=min(self.moe_d_ff, 256),
                      first_dense=min(self.first_dense, 1),
                      moe_capacity_factor=1e9)
        if self.ssm_state:
            kw.update(ssm_state=32, ssm_headdim=16, ssm_chunk=16)
        return dataclasses.replace(self, name=self.name + "-smoke", **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}

ARCH_IDS = [
    "internlm2_1_8b", "deepseek_v2_lite_16b", "whisper_medium", "jamba_v0_1_52b",
    "starcoder2_3b", "deepseek_coder_33b", "internvl2_2b", "mamba2_2_7b",
    "gemma3_12b", "mixtral_8x22b",
]


def get_config(arch: str) -> ModelConfig:
    """The ``CONFIG`` of ``repro_torch.configs.<arch>`` ('-' and '.' read
    as '_')."""
    arch = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


# archs allowed to lower long_500k (sub-quadratic / windowed decode)
LONG_CONTEXT_ARCHS = {"jamba_v0_1_52b", "mamba2_2_7b", "gemma3_12b", "mixtral_8x22b"}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) is part of the dry-run matrix; reason if not."""
    arch = cfg.name.replace("-", "_").replace(".", "_")
    if shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "full-attention arch: long_500k skipped per DESIGN.md §4"
    return True, ""
