"""deepseek-v3-671b  [moe]  — MLA + 1 shared + 256 routed top-8 + MTP.

61L d_model=7168 128H (kv=128 via MLA absorption) d_ff=2048(expert)
vocab=129280, 256 experts top-8.  [arXiv:2412.19437; hf]
MLA dims from the HF config: q_lora 1536, kv_lora 512, qk_nope 128,
qk_rope 64, v_head 128.
"""
from ..models.config import ArchConfig

FULL = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab_size=129280, head_dim=192,
    n_experts=256, experts_per_tok=8, n_shared_experts=1, moe_d_ff=2048,
    router_impl="sigmoid",
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    rope_theta=1e4, mtp=True,
)

SMOKE = FULL.replace(
    name="deepseek-v3-671b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=128, vocab_size=256, n_experts=8, experts_per_tok=2,
    moe_d_ff=32, q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16, mtp=True, remat=False,
)

CONFIGS = [FULL, SMOKE]
