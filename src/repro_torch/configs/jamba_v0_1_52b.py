"""jamba-v0.1-52b — hybrid Mamba+attention (1:7), MoE 16e top-2
[arXiv:2403.19887; hf]."""
from ..models.config import ArchConfig, MoECfg, SSMCfg

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    attn_every=8,                     # groups of [7×mamba, 1×attn]
    moe=MoECfg(num_experts=16, top_k=2, expert_d_ff=14336,
               every_k_layers=2),     # MoE FFN on every other layer
    ssm=SSMCfg(d_state=16, head_dim=64, expand=2, d_conv=4, chunk=128),
    grad_accum=4,
    moe_impl="shard_map",
)
