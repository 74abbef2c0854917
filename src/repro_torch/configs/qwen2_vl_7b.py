"""qwen2-vl-7b — VLM backbone with M-RoPE; vision frontend stubbed
[arXiv:2409.12191; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    use_bias=True,                     # qwen2 uses qkv bias
    mrope_sections=(16, 24, 24),       # t/h/w frequency pairs (sum = 64)
    grad_accum=2,
)
