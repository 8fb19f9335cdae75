"""Parameter / cache partitioner: tree path -> partition spec -> ``DTensor``
placements.

Megatron-style tensor parallelism on the ``model`` axis, (pod×)data
parallelism on the batch dims, expert parallelism for MoE banks, with
divisibility guards (a dim that doesn't divide the mesh axis is replicated:
MQA kv projections with one head, whisper's odd vocab).  The rules are
JAX's ``sharding/partition.py``, rule for rule.

A spec is a ``PartitionSpec``: a tuple with one entry a tensor dim, each
None (replicated), a mesh axis name, or a tuple of names (the dim is
sharded over those axes in order; a tuple of one name is that name, as JAX
normalises it).  ``placements`` turns a spec into one ``Shard`` /
``Replicate`` a mesh dim for ``DTensor``.

The mesh is a ``DeviceMesh`` or any stand-in with ``axis_names`` and a
``shape`` dict (specs never touch devices).  JAX stacks each block-pattern
slot's layers on a leading, never sharded, [G] axis; the port's trees hold
one dict a layer, so every spec here is a layer's own: JAX's spec with
that axis dropped.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.sharding.mesh import axis_names, axis_sizes

Params = Any


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec`` as a tuple: ``P(None, ("data",), "model")``
    equals ``P(None, "data", "model")``."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, (norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _walk(fn: Callable, tree: Any, path: tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists (the port's
    parameter and cache trees; a spec or a placement tuple is a leaf);
    the path's keys are strings (a list index as its digits), as JAX's
    ``tree_map_with_path`` keys read."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    every mesh dim of more than one rank that shards tensor dim d (a dim
    sharded over several axes gets one on each), ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = {}
    sizes = axis_sizes(mesh)
    for d, part in enumerate(spec):
        for name in ((part,) if isinstance(part, str) else part or ()):
            # A split over one rank is that rank's whole tensor.
            if sizes[name] > 1:
                by_axis[name] = Shard(d)
    return tuple(by_axis.get(a, Replicate()) for a in axis_names(mesh))


class Partitioner:
    def __init__(self, mesh, *, model_axis: str = "model",
                 fsdp: bool = True, mla_cache: str = "latent"):
        self.mesh = mesh
        sizes = axis_sizes(mesh)
        self.model_axis = model_axis
        self.model_size = sizes[model_axis]
        # Batch shards over every non-model axis ("pod" included if present).
        self.batch_axes = tuple(a for a in axis_names(mesh)
                                if a != model_axis)
        self.data_size = 1
        for a in self.batch_axes:
            self.data_size *= sizes[a]
        # FSDP: additionally shard each parameter's largest remaining dim
        # over the data axes.
        self.fsdp = fsdp
        # The MLA latent cache: "latent" shards r over model, "replicated"
        # keeps it whole, "seq" shards S over model.
        self.mla_cache = mla_cache

    # -- helpers -----------------------------------------------------------

    def _m(self, dim_size: int):
        """'model' if it divides, else replicated."""
        return self.model_axis if dim_size % self.model_size == 0 else None

    # -- parameter rules ---------------------------------------------------

    _COL = {"wq", "wk", "wv", "gate", "up", "in_gate", "in_rec", "up_mlstm",
            "up_gate", "w_in", "w_q", "w_uk", "w_uv", "head", "gate_i",
            "gate_r", "conv_w"}
    _ROW = {"wo", "down", "out", "w_o", "xattn_out"}
    _REPL = {"router", "w_dkv", "w_kr", "w_if", "kv_norm"}

    def param_spec(self, path: tuple[str, ...],
                   shape: tuple[int, ...]) -> PartitionSpec:
        base = self._base_spec(path, shape)
        if self.fsdp and len(shape) >= 2:
            base = self._fsdpify(base, shape)
        if len(base) > len(shape):
            raise ValueError(f"spec {base} has more dims than {path} "
                             f"{tuple(shape)}")
        return base

    def _fsdpify(self, spec: PartitionSpec, shape) -> PartitionSpec:
        parts = list(spec) + [None] * (len(shape) - len(spec))
        # Largest replicated, divisible dim gets the data axes.
        best, best_dim = None, 0
        for i, (ax, dim) in enumerate(zip(parts, shape)):
            if ax is None and dim % self.data_size == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is not None:
            parts[best] = self.batch_axes
        return P(*parts)

    def _base_spec(self, path: tuple[str, ...], shape) -> PartitionSpec:
        name = path[-1]
        parent = path[-2] if len(path) > 1 else ""

        if name == "w" and parent == "embed":
            return P(self._m(shape[0]), None)            # vocab rows
        if parent in self._REPL or name in self._REPL:
            return P(*([None] * len(shape)))
        # MoE expert banks: expert-parallel on dim 0.
        if parent == "experts":
            return P(self._m(shape[0]), None, None)
        if parent == "shared":
            if name == "down":
                return P(None, self._m(shape[1]), None)
            return P(None, None, self._m(shape[2]))
        if name == "r" and len(shape) == 3:               # sLSTM recurrent
            return P(self._m(shape[0]), None, None)
        if name == "log_lambda":
            return P(self._m(shape[0]))
        if name == "conv_w":
            return P(None, self._m(shape[1]))
        if name == "w":
            if parent in self._COL:
                return P(None, self._m(shape[1]))
            if parent in self._ROW:
                return P(self._m(shape[0]), None)
        if name == "b":
            if parent in self._COL:
                return P(self._m(shape[0]))
            return P(None)
        # norms, pos embeddings, scalars: replicated.
        return P(*([None] * len(shape)))

    def params_specs(self, params: Params) -> Params:
        """Specs of the port's parameter tree (one dict a layer)."""
        return _walk(lambda path, leaf: self.param_spec(
            path, tuple(leaf.shape)), params)

    def params_shardings(self, params: Params) -> Params:
        """``DTensor`` placements of every parameter on the mesh."""
        return _walk(lambda path, spec: placements(spec, self.mesh),
                     self.params_specs(params))

    # -- cache rules (serving) ---------------------------------------------

    def cache_entry_spec(self, path: tuple[str, ...], shape,
                         *, shard_batch: bool) -> PartitionSpec:
        """KV / recurrent cache sharding: heads on 'model' when divisible,
        else the sequence axis; batch on the data axes.  Paged pools are
        shared across rows (dim 0 is pages, never sharded over the data
        axes): MHA pools over heads, MLA latent pools over the
        latent-feature axis; block tables replicate."""
        name = path[-1]
        b_ax = self.batch_axes if shard_batch else None
        if name in ("k_pages", "v_pages"):                # [P, Hkv, ps, D]
            return P(None, self._m(shape[1]), None, None)
        if name == "latent_pages":                        # [P, ps, Dp]
            return P(None, None, self._m(shape[2]))
        if name == "block_tables":                        # [B, maxp]
            return P(None, None)
        if name in ("k", "v", "xk", "xv"):                # [B, Hkv, S, D]
            h_ax = self._m(shape[1])
            s_ax = self._m(shape[2]) if h_ax is None else None
            spec = P(b_ax, h_ax, s_ax, None)
        elif name in ("ckv", "krope"):                    # [B, S, r]
            if self.mla_cache == "seq":
                spec = P(b_ax, self._m(shape[1]), None)
            elif self.mla_cache == "replicated":
                spec = P(b_ax, None, None)
            else:                                          # "latent"
                spec = P(b_ax, None, self._m(shape[2]))
        elif name == "C":                                 # [B, H, dh, dh]
            spec = P(b_ax, self._m(shape[1]), None, None)
        elif name in ("h", "n", "c", "m") and len(shape) == 2:
            spec = P(b_ax, self._m(shape[1]))
        elif name == "conv":                              # [B, cw-1, W]
            spec = P(b_ax, None, self._m(shape[2]))
        elif name in ("n",) and len(shape) == 3:           # mLSTM n [B,H,dh]
            spec = P(b_ax, self._m(shape[1]), None)
        elif name == "m" and len(shape) == 2:
            spec = P(b_ax, None)
        else:
            spec = P(b_ax, *([None] * (len(shape) - 1)))
        return spec

    def cache_specs(self, cache: Params, *, shard_batch: bool = True
                    ) -> Params:
        """Specs of the port's cache tree (one dict a layer)."""
        return _walk(lambda path, leaf: self.cache_entry_spec(
            path, tuple(leaf.shape), shard_batch=shard_batch), cache)

    def cache_shardings(self, cache: Params, *, shard_batch: bool = True
                        ) -> Params:
        """``DTensor`` placements of every cache leaf on the mesh."""
        return _walk(lambda path, spec: placements(spec, self.mesh),
                     self.cache_specs(cache, shard_batch=shard_batch))


# -- trees to and from ``DTensor`` ------------------------------------------

def shard_tensor(t, mesh, placement: tuple):
    """``t`` (the whole tensor, on every rank) as a ``DTensor`` with
    ``placement`` on ``mesh``: each rank keeps its own shard, cut locally
    (no collective), so a ``meta`` tensor on a fake group stays on
    ``meta``.  A ``DTensor`` comes back as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(t, DTensor):
        return t
    return distribute_tensor(t, mesh, placement, src_data_rank=None)


def _shard_tree(tree, placed, mesh):
    return _walk2(lambda t, pl: shard_tensor(t, mesh, pl), tree, placed)


def _walk2(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over two trees of the same dicts and
    lists."""
    if isinstance(tree, dict):
        return {k: _walk2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk2(fn, v, o) for v, o in zip(tree, other, strict=True)]
    return fn(tree, other)


def shard_params(params: Params, part: Partitioner) -> Params:
    """The parameter tree as ``DTensor``s under ``part.params_specs``
    (serving: a ``Partitioner(fsdp=False)``, tensor-parallel only;
    training: ``fsdp=True``)."""
    return _shard_tree(params, part.params_shardings(params), part.mesh)


def shard_cache(cache: Params, part: Partitioner, *,
                shard_batch: bool = True) -> Params:
    """The cache tree as ``DTensor``s under ``part.cache_specs``."""
    return _shard_tree(cache, part.cache_shardings(
        cache, shard_batch=shard_batch), part.mesh)


def shard_opt_state(state, params: Params, part: Partitioner):
    """AdamW state with the moments under the parameters' placements (the
    moments follow the parameters: with FSDP that is ZeRO); the step
    count stays a host scalar."""
    placed = part.params_shardings(params)
    return type(state)(state.step, _shard_tree(state.mu, placed, part.mesh),
                       _shard_tree(state.nu, placed, part.mesh))


def shard_batch(x, mesh, dp_axes: tuple[str, ...]):
    """A batch-major tensor as a ``DTensor`` with its rows over the data
    axes (replicated where the rows do not divide them), as JAX's
    ``in_shardings`` give a step's batch inputs."""
    from repro_torch.sharding.mesh import axis_sizes
    sizes = axis_sizes(mesh)
    ways = 1
    for a in dp_axes:
        ways *= sizes[a]
    rows = dp_axes if x.shape[0] % ways == 0 else None
    return shard_tensor(x, mesh, placements(
        P(rows, *([None] * (x.dim() - 1))), mesh))


def full_tensor(tree: Any) -> Any:
    """Every ``DTensor`` of a tree of dicts, lists and tuples gathered
    whole (a collective on every rank); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: full_tensor(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(full_tensor(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tensor(v) for v in tree)
    return tree
