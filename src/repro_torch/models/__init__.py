from .config import ArchConfig, EncDecCfg, MoECfg, SSMCfg
from .params import (P, NamedSharding, init_params, local, param_specs, place,
                     shardings_for)
from . import convert, layers, lm, moe, registry

__all__ = [
    "ArchConfig", "EncDecCfg", "MoECfg", "SSMCfg",
    "P", "NamedSharding", "init_params", "local", "param_specs", "place",
    "shardings_for",
    "convert", "layers", "lm", "moe", "registry",
]
