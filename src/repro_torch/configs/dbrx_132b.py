"""dbrx-132b  [moe] — 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.
[hf:databricks/dbrx-base; unverified]
"""
from ..models.config import ArchConfig

FULL = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    n_experts=16, experts_per_tok=4, moe_d_ff=10752,
    rope_theta=5e5,
)

SMOKE = FULL.replace(
    name="dbrx-132b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, n_experts=4, experts_per_tok=2, moe_d_ff=128,
    remat=False,
)

CONFIGS = [FULL, SMOKE]
