"""mamba2-130m — attention-free SSM via state-space duality
[arXiv:2405.21060; unverified]."""
from ..models.config import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=1, num_kv_heads=1,
    d_ff=0,                            # mamba blocks have no FFN
    vocab_size=50280,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=128),
    tie_embeddings=True,
)
