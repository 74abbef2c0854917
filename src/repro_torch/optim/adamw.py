"""AdamW with fp32 moments over (possibly bf16) params (twin of the JAX
package's ``optim/adamw.py``).

The rules are the reference's: fp32 moments, bias correction from an int32
``step``, weight decay on every leaf with ``ndim >= 2`` (so the stacked
norm weights ``blocks.ln1``/``ln2``, (L, D), are decayed and only
``final_norm`` is not), and the update computed in fp32 and cast back to
the param's dtype. Functional, as the reference: ``update`` returns new
trees and leaves its inputs as they are. It works leaf by leaf, so each
leaf's fp32 temporaries are freed before the next leaf's are made; the old
and the new moments are both alive until the caller drops the old state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def update(params: Any, grads: Any, state: AdamWState, *,
           lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1) -> tuple[Any, AdamWState]:
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1 - b1 ** t
    c2 = 1 - b2 ** t

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g.square()
        delta = (m_new / c1) / ((v_new / c2).sqrt() + eps)
        if weight_decay and p.ndim >= 2:   # no decay on norms/biases
            delta = delta + weight_decay * p.to(torch.float32)
        p_new = p.to(torch.float32) - lr * delta
        return p_new.to(p.dtype), m_new, v_new

    flat_p, treedef = tree_flatten(params)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(flat_p, tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        p_new, m_new, v_new = upd(p, g, m, v)
        new_p.append(p_new)
        new_m.append(m_new)
        new_v.append(v_new)
    return (tree_unflatten(treedef, new_p),
            AdamWState(m=tree_unflatten(treedef, new_m),
                       v=tree_unflatten(treedef, new_v), step=step))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(l.to(torch.float32).square().sum()
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm
