"""zamba2-7b  [hybrid] — Mamba2 stack + shared attention block.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.
[arXiv:2411.15242; unverified]  Shared attn applied every 6 layers over
concat(hidden, embedding) — the zamba shared-block design.
"""
from ..models.config import ArchConfig

FULL = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    attn_every=6,
)

SMOKE = FULL.replace(
    name="zamba2-7b-smoke",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, ssm_state=16, ssm_head_dim=16, attn_every=2,
    remat=False,
)

CONFIGS = [FULL, SMOKE]
