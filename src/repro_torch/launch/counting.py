"""What one rank runs and sends: the dry run's counter.

``LocalCounter`` is a ``TorchDispatchMode`` that counts, over one eager
call, the FLOPs and the operand + result bytes of every aten op a rank
runs, and the bytes each collective moves through that rank's links.  On
a ``DTensor`` op it returns ``NotImplemented``: ``DTensor`` then runs the
op (its sharding propagation on fake tensors, which are not counted; its
redistributions as functional collectives) and the local ops it issues on
the rank's shards come back through this mode, where they are counted at
their local shapes.  ``FlopCounterMode`` alone counts a ``DTensor`` op at
its global shape (a [64, 2048] @ [2048, 8192] product sharded 16 × 16
counts 2.15e9, not the rank's 8.4e6).

Collective bytes follow JAX's ring model (``repro/launch/dryrun.py``
``collective_bytes``), per op kind:

  all-gather           output bytes
  all-reduce           2 × operand bytes
  reduce-scatter       operand bytes
  all-to-all           operand bytes
  collective-permute   operand bytes (a ring shift: each rank's send)

for functional collectives (``_c10d_functional``: what ``DTensor``
redistributes with) and eager c10d ones (``c10d``: what the fused step's
coordination merges call through ``core.merge.GroupAxis``) alike; a
receive moves the matching send's bytes and is not counted again.

``scans_once=True`` switches on the recurrent scans' shortcut
(``models/scan.py``): a scan counts one step times its length.
"""
from __future__ import annotations

import torch
import torch.fx.experimental._config as fx_config
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVE_METHOD = (
    "LocalCounter: the collectives one rank of the fake production mesh "
    "issues in the sharded step (DTensor's redistributions and the eager "
    "c10d merges), bytes by JAX's ring model: all-gather output, "
    "all-reduce 2 x operand, reduce-scatter / all-to-all / "
    "collective-permute operand")

# Op name (the overload packet's, namespace stripped) -> JAX's op kind.
_KINDS = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute",
}
_COMM_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional",
                    "_c10d_functional_autograd", "_dtensor")
_FLOPS = FlopCounterMode(display=False).flop_registry


def _nbytes(obj) -> int:
    leaves, _ = tree_flatten(obj)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _fake_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class LocalCounter(TorchDispatchMode):
    """FLOPs, bytes, op count and collective bytes by kind of the local
    ops run while the mode is active, each times ``factor``.  Only ops
    on ``device`` tensors are counted (None: every op)."""

    def __init__(self, *, scans_once: bool = False,
                 device: str | None = "meta"):
        super().__init__()
        self.device = device
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives: dict[str, int] = {}
        self.factor = 1
        self.scans_once = scans_once
        self._inner = 0
        self._depth = 0

    def __enter__(self):
        out = super().__enter__()
        # Re-entered to count a decomposition: switch the scans once.
        self._depth += 1
        if self.scans_once and self._depth == 1:
            from repro_torch.models import scan
            self._scans = scan.counted_once(self)
            self._scans.__enter__()
        return out

    def __exit__(self, *exc):
        self._depth -= 1
        if self.scans_once and self._depth == 0:
            self._scans.__exit__(*exc)
        return super().__exit__(*exc)

    def _made_on_device(self, kwargs) -> bool:
        """A factory op (no tensor operand) making a ``device`` tensor."""
        dev = kwargs.get("device")
        return dev is not None and torch.device(dev).type == self.device

    def _collective(self, func, kind: str, args, out) -> None:
        # Eager c10d ops take their outputs first: all-gather's gathered
        # list, reduce-scatter's and all-to-all's operand second.
        eager = func.namespace == "c10d"
        if kind == "all-gather":
            b = _nbytes(args[0] if eager else out)
        elif kind == "all-reduce":
            b = 2 * _nbytes(args[0])
        elif eager and kind in ("reduce-scatter", "all-to-all"):
            b = _nbytes(args[1])
        else:
            b = _nbytes(args[0])
        b *= self.factor
        self.collectives[kind] = self.collectives.get(kind, 0) + b
        self.collectives["total"] = self.collectives.get("total", 0) + b

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        leaves, _ = tree_flatten((args, kwargs))
        if any(isinstance(t, DTensor) for t in leaves):
            return NotImplemented
        if _fake_active():
            return func(*args, **kwargs)
        if self.device is not None and not any(
                isinstance(t, torch.Tensor) and t.device.type == self.device
                for t in leaves) and not self._made_on_device(kwargs):
            # Host-side work: DTensor's index math for a redistribution,
            # on CPU tensors beside a step whose tensors are on meta.
            return func(*args, **kwargs)
        packet = func._overloadpacket
        ns = func.namespace
        if ns in _COMM_NAMESPACES:
            out = func(*args, **kwargs)
            kind = _KINDS.get(packet.__name__)
            if kind is not None:
                self._collective(func, kind, args, out)
            return out
        if not self._inner and not _is_view(func):
            self.bytes += self.factor * _nbytes((args, kwargs))
            self.ops += self.factor
            count_out = True
        else:
            count_out = False
        if packet not in _FLOPS and func is not torch.ops.prim.device.default:
            self._inner += 1
            try:
                with self:
                    r = func.decompose(*args, **kwargs)
            finally:
                self._inner -= 1
            if r is not NotImplemented:
                if count_out:
                    self.bytes += self.factor * _nbytes(r)
                return r
        out = func(*args, **kwargs)
        if count_out:
            self.bytes += self.factor * _nbytes(out)
        if packet in _FLOPS:
            self.flops += self.factor * int(_FLOPS[packet](
                *args, **kwargs, out_val=out))
        return out

    def result(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "ops": self.ops,
                "collectives": {k: float(v)
                                for k, v in self.collectives.items()}}


def count(fn, *, scans_once: bool = True,
          device: str | None = "meta") -> dict:
    """FLOPs, bytes, op count and collective bytes by kind of one eager
    call of ``fn`` as one rank runs it (on ``meta`` tensors:
    data-dependent selections count every element as selected)."""
    with fx_config.patch(meta_nonzero_assume_all_nonzero=True), \
            LocalCounter(scans_once=scans_once, device=device) as c:
        fn()
    return c.result()

