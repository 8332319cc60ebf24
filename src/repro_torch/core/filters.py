"""Gradient filters from the paper's related work (§3) and the §5
combination, on torch tensors.

Port of ``repro.core.filters``: the baselines the paper positions
against (they need distributional assumptions, not redundancy, and do
not give exact fault tolerance).  Every filter takes stacked worker
gradients (n, d) and returns one (d,) vector in the input's dtype; the
engines hand them float32, as the reference's JAX filters compute.

A median over an even count averages the two middle values, as
``jnp.median`` does (``torch.median`` would return the lower one).

``reduce``: where the columns are one shard of a leaf split over the
model axis, the filters that need a distance or a norm over the whole
leaf (``krum``, ``gmom``, ``norm_clip``) sum their partial sums of
squares with it (the trainer passes the axis's all-reduce); the others
are coordinate-wise and need nothing.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree as tree_mod


def _median(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Median along ``dim``; an even count gives the mean of the two
    middle values."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    lo = s.narrow(dim, (n - 1) // 2, 1).squeeze(dim)
    hi = s.narrow(dim, n // 2, 1).squeeze(dim)
    return 0.5 * (lo + hi)


def mean(grads: torch.Tensor) -> torch.Tensor:
    return grads.mean(dim=0)


def coordinate_median(grads: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median (Yin et al., 2018)."""
    return _median(grads, 0)


def trimmed_mean(grads: torch.Tensor, f: int) -> torch.Tensor:
    """Coordinate-wise f-trimmed mean (Yin et al., 2018)."""
    n = grads.shape[0]
    if 2 * f >= n:
        raise ValueError("need 2f < n for trimmed mean")
    s = torch.sort(grads, dim=0).values
    return s[f: n - f].mean(dim=0)


def _whole(reduce):
    return (lambda t: t) if reduce is None else reduce


def krum(grads: torch.Tensor, f: int, m: int = 1, *,
         reduce=None) -> torch.Tensor:
    """(Multi-)KRUM (Blanchard et al., 2017): score each worker by the
    sum of squared distances to its n-f-2 closest peers and return the
    mean of the m best-scored gradients (ties to the lower index)."""
    n = grads.shape[0]
    d2 = _whole(reduce)(
        ((grads[:, None, :] - grads[None, :, :]) ** 2).sum(dim=-1))
    d2 = d2 + torch.eye(n, dtype=grads.dtype, device=grads.device) * 1e30
    kth = max(1, n - f - 2)
    nearest = torch.sort(d2, dim=1).values[:, :kth]
    scores = nearest.sum(dim=1)
    best = torch.argsort(scores, stable=True)[:m]
    return grads[best].mean(dim=0)


def geometric_median_of_means(grads: torch.Tensor, num_buckets: int,
                              iters: int = 16, *,
                              reduce=None) -> torch.Tensor:
    """Geometric median of bucket means (Chen et al., 2017), ``iters``
    Weiszfeld steps."""
    n, d = grads.shape
    b = max(1, num_buckets)
    usable = (n // b) * b
    means = grads[:usable].reshape(b, -1, d).mean(dim=1)       # (b, d)
    z = means.mean(dim=0)
    for _ in range(iters):
        dist = torch.sqrt(_whole(reduce)(
            (means - z[None]).square().sum(dim=1))) if reduce is not None \
            else torch.linalg.vector_norm(means - z[None], dim=1)
        w = 1.0 / torch.clamp(dist, min=1e-8)
        z = (means * w[:, None]).sum(dim=0) / w.sum()
    return z


def norm_clip(grads: torch.Tensor, clip: float | None = None, *,
              reduce=None) -> torch.Tensor:
    """Norm clipping (Gupta & Vaidya, 2019): scale each gradient to at
    most the median norm (or a fixed clip), then average."""
    norms = torch.sqrt(reduce(grads.square().sum(dim=1))) \
        if reduce is not None else torch.linalg.vector_norm(grads, dim=1)
    ref = _median(norms) if clip is None else clip
    factor = torch.clamp(ref / torch.clamp(norms, min=1e-12), max=1.0)
    return (grads * factor[:, None]).mean(dim=0)


FILTERS = {
    "mean": lambda g, f, reduce=None: mean(g),
    "median": lambda g, f, reduce=None: coordinate_median(g),
    "trimmed_mean": lambda g, f, reduce=None: trimmed_mean(g, f),
    "krum": lambda g, f, reduce=None: krum(g, f, reduce=reduce),
    # >= 2f+1 buckets so corrupted buckets are a strict minority
    "gmom": lambda g, f, reduce=None: geometric_median_of_means(
        g, min(g.shape[0], 2 * f + 1) if f else g.shape[0], reduce=reduce
    ),
    "norm_clip": lambda g, f, reduce=None: norm_clip(g, reduce=reduce),
}


def filter_tree(grad_trees, name: str, f: int):
    """A filter applied leaf-wise over a tree of stacked gradients
    (leading n), in f32, each result cast back to its leaf's dtype."""
    fn = FILTERS[name]

    def per_leaf(leaf):
        n = leaf.shape[0]
        flat = leaf.reshape(n, -1).to(torch.float32)
        return fn(flat, f).reshape(leaf.shape[1:]).to(leaf.dtype)

    return tree_mod.unflatten(grad_trees, [per_leaf(leaf) for leaf in
                                           tree_mod.leaves(grad_trees)])
