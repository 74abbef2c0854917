"""yi-9b — llama-arch dense GQA [arXiv:2403.04652; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    grad_accum=2,
)
