"""Gradient compression with error feedback (paper §5 generalization).

Port of ``repro.optim.compression``: signSGD-style 1-bit compression
(Bernstein et al., 2018) with a per-tensor scale and error feedback,
the residual carried to the next iteration so compression stays
unbiased over time.  Replicas of one gradient compress to identical
symbols, so detection and voting can compare the compressed form.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree


def init_error_feedback(params):
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)


def compress_tree(grads, errors):
    """Sign compression with error feedback.

    Returns (a tree of {"sign": int8, "scale": () f32} per leaf,
    new_errors)."""
    comp, new_err = [], []
    for g, e in zip(tree.leaves(grads), tree.leaves(errors)):
        corrected = g.to(torch.float32) + e
        scale = corrected.abs().mean()
        sign = torch.sign(corrected)
        comp.append({"sign": sign.to(torch.int8), "scale": scale})
        new_err.append(corrected - sign * scale)
    return tree.unflatten(grads, comp), tree.unflatten(grads, new_err)


def _is_symbol(x) -> bool:
    return isinstance(x, dict) and "sign" in x


def decompress_tree(compressed):
    if _is_symbol(compressed):
        return compressed["sign"].to(torch.float32) * compressed["scale"]
    if isinstance(compressed, dict):
        return {k: decompress_tree(v) for k, v in compressed.items()}
    return [decompress_tree(v) for v in compressed]
