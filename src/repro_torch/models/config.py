"""Architecture configuration: every model of the port is an ArchConfig.

The port's copy of ``repro.models.config``, field for field, with
``dtype`` a ``torch.dtype`` (default ``torch.bfloat16``).  ``remat`` is
kept as a field: it has no effect on a forward pass or a decode step
(training maps it to ``torch.utils.checkpoint``, ROADMAP A.9).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0             # routed-expert hidden dim
    moe_cap_factor: float = 1.25
    router_impl: str = "softmax"  # 'softmax' | 'sigmoid' (dsv3)

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    sliding_window: int = 0       # 0 = full causal
    causal: bool = True

    # --- ssm / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0           # zamba2: shared attn block cadence
    xlstm_slstm_every: int = 2    # xlstm: every k-th block is sLSTM

    # --- multimodal stubs ---
    mrope: bool = False           # qwen2-vl
    vis_prefix_frac: float = 0.25 # fraction of seq that is patch embeds
    enc_dec: bool = False         # whisper
    enc_layers: int = 0
    enc_len_frac: float = 0.25    # encoder frames as fraction of seq_len

    # --- extras ---
    mtp: bool = False             # deepseek multi-token prediction head
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM/hybrid) -> long_500k runs."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
