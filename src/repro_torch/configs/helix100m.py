"""helix100m — ~100M-param dense LM used by the end-to-end training example
(examples/train_lm.py) and integration tests. Not an assigned arch."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="helix100m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=32768,
)
