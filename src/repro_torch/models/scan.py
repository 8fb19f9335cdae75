"""Time scans counted once: the dry run's shortcut for the recurrent cells.

The port's time scans (``xlstm._scan``, ``kernels.ref.linear_scan``) are
Python loops of one step per token, every step of one shape.  Counted op
by op on ``meta`` tensors they take minutes to hours at 4k-32k tokens
(xlstm-125m's train cell 42 min).  The dry run's counter
(``launch/counting.LocalCounter(scans_once=True)``) switches this
shortcut on: a scan then runs its first step only, with the counter's
factor multiplied by the number of steps, and builds its outputs at full
shape from that step.  FLOPs, bytes and op counts are those of the whole
loop (``tests/test_torch_dryrun.py`` holds them equal at a reduced
length); under autograd the step's backward is counted at the same
factor.

The shortcut acts only inside that counter and only on ``meta`` tensors
(a ``DTensor``'s local shard): a scan over real data asking for it raises,
since its values would be wrong.
"""
from __future__ import annotations

import contextlib

import torch

_COUNTERS: list = []


@contextlib.contextmanager
def counted_once(counter):
    """Switch the shortcut on for ``counter`` (a dispatch mode with an
    integer ``factor``) while the block runs; the counter must be the
    innermost active dispatch mode."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    if counter is None or _get_current_dispatch_mode() is not counter:
        raise RuntimeError("scans are counted once only inside the dry "
                           "run's counter, entered before this switch")
    _COUNTERS.append(counter)
    try:
        yield
    finally:
        _COUNTERS.pop()


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class _Boundary(torch.autograd.Function):
    """Identity in the forward; in the backward it multiplies (``mul``) or
    divides the counter's factor, so the step's backward between the two
    boundaries is counted as many times as its forward."""

    @staticmethod
    def forward(ctx, counter, n, mul, *ts):
        ctx.counter, ctx.n, ctx.mul = counter, n, mul
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.mul:
            ctx.counter.factor *= ctx.n
        else:
            ctx.counter.factor //= ctx.n
        return (None, None, None, *grads)


class Once:
    """One step standing for ``n``: ``enter`` the step's inputs, run it,
    ``exit`` its outputs."""

    def __init__(self, counter, n: int):
        self.counter, self.n = counter, n
        self.graph = False

    def enter(self, tensors: list) -> list:
        """The step's inputs, through a boundary that ends the scaled
        backward where a gradient flows to them."""
        self.graph = torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors)
        if self.graph:
            tensors = list(_Boundary.apply(self.counter, self.n, False,
                                           *tensors))
        self.counter.factor *= self.n
        return tensors

    def exit(self, tensors: list) -> list:
        """The step's outputs, through a boundary that starts the scaled
        backward.  Without a gradient into the inputs there is no boundary
        to end it, and the step's backward is counted once."""
        self.counter.factor //= self.n
        if self.graph:
            tensors = list(_Boundary.apply(self.counter, self.n, True,
                                           *tensors))
        return tensors


def once(n: int, tensors) -> Once | None:
    """A ``Once`` for a scan of ``n`` steps over ``tensors`` while the
    shortcut is on, else None (the scan runs every step)."""
    if not _COUNTERS:
        return None
    real = [t for t in tensors if _local(t).device.type != "meta"]
    if real:
        raise ValueError(
            f"a scan over {real[0].device} tensors asked to be counted "
            f"once: the shortcut runs only on meta tensors")
    return Once(_COUNTERS[-1], n)
