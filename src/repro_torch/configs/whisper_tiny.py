"""whisper-tiny  [audio] — enc-dec, conv frontend stubbed.

4L (enc=dec=4) d_model=384 6H d_ff=1536 vocab=51865.
[arXiv:2212.04356; unverified]  input_specs provides precomputed frame
embeddings (the 2xConv1d stem output).
"""
from ..models.config import ArchConfig

FULL = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    enc_dec=True, enc_layers=4, tie_embeddings=True,
)

SMOKE = FULL.replace(
    name="whisper-tiny-smoke",
    n_layers=2, enc_layers=2, d_model=48, n_heads=2, n_kv_heads=2,
    d_ff=96, vocab_size=256, remat=False,
)

CONFIGS = [FULL, SMOKE]
