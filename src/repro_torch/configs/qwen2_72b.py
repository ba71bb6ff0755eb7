"""qwen2-72b  [dense] — GQA + QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
[arXiv:2407.10671; hf]
"""
from ..models.config import ArchConfig

FULL = ArchConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
)

SMOKE = FULL.replace(
    name="qwen2-72b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=256, qkv_bias=True, remat=False,
)

CONFIGS = [FULL, SMOKE]
