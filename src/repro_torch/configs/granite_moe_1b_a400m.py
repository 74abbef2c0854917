"""granite-moe-1b-a400m — 32 experts, top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from ..models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    moe=MoECfg(num_experts=32, top_k=8, expert_d_ff=512),
    moe_impl="shard_map",
)
