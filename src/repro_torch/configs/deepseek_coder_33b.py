"""deepseek-coder-33b  [dense] — llama-arch.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
[arXiv:2401.14196; hf]
"""
from ..models.config import ArchConfig

FULL = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab_size=32256, rope_theta=1e5,
)

SMOKE = FULL.replace(
    name="deepseek-coder-33b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab_size=256, remat=False,
)

CONFIGS = [FULL, SMOKE]
