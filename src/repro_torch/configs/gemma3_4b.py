"""gemma3-4b — dense GQA, 5:1 local:global sliding window, 128k ctx
[hf:google/gemma-3-1b-pt; unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
    d_ff=10240, vocab_size=262144, head_dim=256,
    window=1024, global_every=6,   # layers 5, 11, … are global
    grad_accum=2,
    window_cache=True,
)
