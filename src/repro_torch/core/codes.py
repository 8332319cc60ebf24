"""Detection codes (paper §4.1), on torch tensors.

Port of ``repro.core.codes``.  The paper's scheme works with any
f-fault-detection code; it uses replication as the worked example and
Figure 2's linear code as a communication-efficient alternative:

 * ``ReplicationCode``: each symbol is the worker's (mean) gradient for
   its shard set; replicas compare equal iff honest.  The train steps
   use it, with sketch compression (``core.detection``).
 * ``Fig2Code``: the n = 3, f = 1 linear code of Figure 2.  Workers hold
   shard pairs (1, 2), (2, 3), (3, 1) and send
       c1 = g1 + 2 g2,   c2 = -g2 + g3,   c3 = -g1 - 2 g3.
   Then c1 + c2 = -(c2 + c3) = (c1 - c3) / 2 = g1 + g2 + g3; a
   disagreement between the three estimates detects (but cannot
   identify) one faulty symbol, at half the communication of
   replication.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.detection import DEFAULT_TAU


class ReplicationCode:
    """Symbols are shard-mean gradients; groups of r = f+1 share shard
    sets."""

    def __init__(self, f: int):
        self.f = f
        self.replication = f + 1

    def encode(self, shard_grads: torch.Tensor) -> torch.Tensor:
        """shard_grads: (m_i, d) gradients of the worker's shards."""
        return shard_grads.mean(dim=0)

    def check(self, symbols: torch.Tensor,
              tau: float = DEFAULT_TAU) -> torch.Tensor:
        """symbols: (r, d) group replicas -> () bool, consistent."""
        ref = symbols[0]
        scale = 1.0 + ref.abs()
        return ((symbols - ref[None]).abs() <= tau * scale[None]).all()

    def decode(self, symbols: torch.Tensor) -> torch.Tensor:
        return symbols[0]


class Fig2Code:
    """The paper's Figure-2 linear detection code (n = 3, f = 1): worker
    1 computes (g1, g2), worker 2 (g2, g3), worker 3 (g3, g1); each sends
    one symbol.  Three estimates of S = g1 + g2 + g3 exist, and any one
    faulty symbol breaks their agreement."""

    n = 3
    f = 1
    #: shard ids per worker (0-indexed)
    shards = ((0, 1), (1, 2), (2, 0))

    @staticmethod
    def encode(worker: int, ga: torch.Tensor,
               gb: torch.Tensor) -> torch.Tensor:
        if worker == 0:
            return ga + 2.0 * gb          # c1 = g1 + 2 g2
        if worker == 1:
            return -ga + gb               # c2 = -g2 + g3
        if worker == 2:
            return -gb - 2.0 * ga         # c3 = -g1 - 2 g3 (ga = g3, gb = g1)
        raise ValueError(worker)

    @staticmethod
    def estimates(c1, c2, c3):
        """The three parity estimates of S = g1 + g2 + g3."""
        return c1 + c2, -(c2 + c3), 0.5 * (c1 - c3)

    @classmethod
    def check(cls, c1, c2, c3, tau: float = DEFAULT_TAU) -> torch.Tensor:
        e1, e2, e3 = cls.estimates(c1, c2, c3)
        scale = 1.0 + e1.abs()
        ok12 = ((e1 - e2).abs() <= tau * scale).all()
        ok13 = ((e1 - e3).abs() <= tau * scale).all()
        return ok12 & ok13

    @classmethod
    def decode(cls, c1, c2, c3) -> torch.Tensor:
        return c1 + c2

    @staticmethod
    def reactive_symbols(c: Sequence[torch.Tensor]):
        """The reactive round (Figure 2): worker i forwards the two
        symbols of the other workers, u1 = (c2, c3), u2 = (c3, c1),
        u3 = (c1, c2); the master votes each c_j over its 2f+1 = 3
        copies."""
        c1, c2, c3 = c
        return (c2, c3), (c3, c1), (c1, c2)
