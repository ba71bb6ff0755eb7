"""internlm2-1.8b  [dense] — GQA.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
[arXiv:2403.17297; hf]
"""
from ..models.config import ArchConfig

FULL = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92544, rope_theta=1e6,
)

SMOKE = FULL.replace(
    name="internlm2-1.8b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, remat=False,
)

CONFIGS = [FULL, SMOKE]
