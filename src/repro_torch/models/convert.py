"""Carry the JAX package's parameters (or any numpy tree) across to torch.

Input is the nested dict of numpy arrays that
``jax.tree_util.tree_map(np.asarray, params)`` gives; output is the same
tree, leaf for leaf, as torch tensors. bf16 leaves cross as raw bits, found
by dtype name, so the port needs neither ``ml_dtypes`` nor ``jax``.
``train_state_from_numpy`` carries a whole ``TrainState`` (params, fp32
moments, int32 step) the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .params import tree_map


def tensor_from_numpy(arr: np.ndarray, device: torch.device | str = "cpu"
                      ) -> torch.Tensor:
    arr = np.array(arr, order="C")   # a writable copy: torch shares its memory
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    return tree_map(lambda a: tensor_from_numpy(np.asarray(a), device), tree)


def train_state_from_numpy(tree: Any, device: torch.device | str = "cpu"):
    """The reference's ``TrainState`` with numpy leaves (``params``, and
    ``opt`` = ``AdamWState(m, v, step)``) as the port's ``TrainState``."""
    from ..optim.adamw import AdamWState
    from ..train.steps import TrainState
    opt = tree.opt
    return TrainState(
        params=params_from_numpy(tree.params, device),
        opt=AdamWState(m=params_from_numpy(opt.m, device),
                       v=params_from_numpy(opt.v, device),
                       step=tensor_from_numpy(np.asarray(opt.step), device)))
