"""The dry-run's hook in the kernel wrappers.

``launch.dryrun.StepCounter`` counts a step's operators; a hand-written
kernel is one operator to it, whose FLOPs and bytes are its own
(``launch.roofline.kernel_cost``), not those of the tensors its wrapper
allocates.  While a counter is active (``COUNTER``), each wrapper on
the model and trainer paths runs its kernel, or on ``meta`` tensors its
shape-only form, inside ``counter.kernel(name, cost)``.  With none
active the wrappers pay one test of this module's global.
"""
from __future__ import annotations

import contextlib

COUNTER = None      # the active launch.dryrun.StepCounter, or None
AXIS = None         # (mesh axis, group size) of the collective under way
STAGING = False     # gloo on a card: the operand's round trip to the host


def run(name: str, cost, fn):
    """``fn()``, accounted to the active counter, if any, as one call of
    kernel ``name`` costing ``cost()`` (a ``roofline.KernelCost``)."""
    counter = COUNTER
    if counter is None:
        return fn()
    with counter.kernel(name, cost()):
        return fn()


def refuse_meta(name: str) -> None:
    raise NotImplementedError(
        f"{name} has no shape-only form: the dry-run (launch.dryrun) "
        f"covers the model and trainer paths, whose kernels are "
        f"flash_attention, sketch and the pairwise_relmax votes; pass "
        f'impl="torch" to trace its plain version on meta tensors')


@contextlib.contextmanager
def collective(axis: str, size: int):
    """Marks the collectives issued inside as over mesh axis ``axis`` of
    ``size`` ranks, so the counter prices each over its own group."""
    global AXIS
    prev, AXIS = AXIS, (axis, size)
    try:
        yield
    finally:
        AXIS = prev


@contextlib.contextmanager
def staging():
    """Marks the copies that take a collective's operand to host memory
    and back (gloo on a card, ``train.ranks``): the counter leaves them
    out, as they are no part of the step (``Ranks.counts`` holds them)."""
    global STAGING
    prev, STAGING = STAGING, True
    try:
        yield
    finally:
        STAGING = prev
