"""xlstm-125m  [ssm] — alternating sLSTM + mLSTM blocks.

12L d_model=768 4H d_ff=0 (blocks carry their own projections)
vocab=50304.  [arXiv:2405.04517; unverified]
"""
from ..models.config import ArchConfig

FULL = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
)

SMOKE = FULL.replace(
    name="xlstm-125m-smoke",
    n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, vocab_size=128,
    remat=False,
)

CONFIGS = [FULL, SMOKE]
