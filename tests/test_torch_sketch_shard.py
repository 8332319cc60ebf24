"""K4s's shard form reads a split gradient leaf in its own dtype.

On the CPU the shard form is its plain version, so these tests hold
what surrounds the kernel: the cost the dry-run counts for a call
(``launch.roofline.kernel_cost``: the bytes of the block's dtype, f32
outputs) and the meta trace of a split check step, in which no split
leaf's shard is copied to f32 before its sketch.  The kernel itself is
held against its plain version on the card (``tests/test_torch_cuda.py``,
marker ``cuda``); its sums against the reference's in
``tests/test_torch_tp.py``.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch_threads import one_thread  # noqa: F401 (one thread)


@pytest.mark.parametrize("dtype,item", [("float32", 4), ("bfloat16", 2)])
def test_shard_cost_counts_the_blocks_dtype(dtype, item):
    from repro_torch.launch.roofline import kernel_cost

    cost = kernel_cost("sketch_shard", d=1000, k=256, dtype=dtype)
    assert cost.bytes == 1000 * item + 256 * 4
    assert (cost.flops, cost.dtype) == (2000, "float32")


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_shard_form_refuses_other_dtypes(dtype):
    """The kernel reads f32 and bf16 only; its shape-only form (meta)
    refuses another dtype as the card would, and copies nothing."""
    from repro_torch.kernels import ops

    block = torch.empty((2, 8), dtype=dtype, device="meta")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.sketch_shard(block, 1, 256, 16, 8)


class _Widenings(TorchDispatchMode):
    """Records the element count of every operator output that is f32
    where an input is bf16 (a copy that widens)."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if isinstance(out, torch.Tensor) and out.dtype == torch.float32 \
                and any(t.dtype == torch.bfloat16 for t in ins):
            self.numels.append(out.numel())
        return out


def test_split_check_step_copies_no_split_leaf(monkeypatch):
    """The ``--mesh tp`` dry-run's meta trace of model rank 0's check
    step (reduced llama3.2-1b in bf16, model 2): inside ``sketch_tree``
    the only bf16 -> f32 copies are the single form's of the replicated
    leaves; each split leaf's shard goes to the shard form as it is,
    counted at 2 bytes an element."""
    from repro_torch.configs import get_config
    from repro_torch.core import detection, tree
    from repro_torch.launch import dryrun as D
    from repro_torch.models import convert
    from repro_torch.sharding import MeshShape

    cfg = get_config("llama3.2-1b").reduced()
    assert cfg.dtype == "bfloat16"
    seen = _Widenings()
    real = detection.sketch_tree
    calls = []

    def traced(*args, **kwargs):
        calls.append(1)
        with seen:
            return real(*args, **kwargs)

    monkeypatch.setattr(detection, "sketch_tree", traced)
    step = D.run_bft_cells(cfg.name, 4, 1, global_batch=8, seq_len=16,
                           mesh="tp", model=2, cfg=cfg, data_ranks=1,
                           modes=("check",))["check"]
    pls = tree.leaves(convert.placements(
        cfg, MeshShape(("data", "model"), (1, 2)), {"data": 0, "model": 0}))
    split = [pl for pl in pls if pl.sharded]
    whole = [pl for pl in pls if not pl.sharded]
    members = len(calls)
    assert members > 0 and split and whole
    assert sorted(seen.numels) == sorted(
        [int(torch.Size(pl.shape).numel()) for pl in whole] * members)
    shard = step["kernels"]["sketch_shard"]
    assert shard["calls"] == members * len(split)
    assert shard["bytes"] == members * sum(
        2 * torch.Size(pl.local_shape).numel() + 256 * 4 for pl in split)
