"""whisper-medium — enc-dec audio backbone; conv frontend stubbed
[arXiv:2212.04356; unverified]."""
from ..models.config import ArchConfig, EncDecCfg

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    use_bias=True,
    encdec=EncDecCfg(enc_layers=24, dec_layers=24, cross_len=1500),
)
