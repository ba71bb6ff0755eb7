"""starcoder2-7b  [dense] — GQA, RoPE (4k sliding window).

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
[arXiv:2402.19173; hf]
"""
from ..models.config import ArchConfig

FULL = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152, rope_theta=1e5,
    sliding_window=4096,
)

SMOKE = FULL.replace(
    name="starcoder2-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, sliding_window=64, remat=False,
)

CONFIGS = [FULL, SMOKE]
