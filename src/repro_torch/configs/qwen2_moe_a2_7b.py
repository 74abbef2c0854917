"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from ..models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    use_bias=True,
    moe=MoECfg(num_experts=60, top_k=4, expert_d_ff=1408,
               num_shared=4, shared_d_ff=5632),
    moe_impl="shard_map",
)
