from .config import ArchConfig, EncDecCfg, MoECfg, SSMCfg
from .params import P, init_params
from . import convert, layers, lm, moe, registry

__all__ = [
    "ArchConfig", "EncDecCfg", "MoECfg", "SSMCfg",
    "P", "init_params",
    "convert", "layers", "lm", "moe", "registry",
]
