"""qwen2-vl-2b  [vlm] — M-RoPE, dynamic resolution (frontend stubbed).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
[arXiv:2409.12191; hf]  input_specs provides precomputed patch embeds.
"""
from ..models.config import ArchConfig

FULL = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, mrope=True, rope_theta=1e6,
)

SMOKE = FULL.replace(
    name="qwen2-vl-2b-smoke",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, remat=False,
)

CONFIGS = [FULL, SMOKE]
