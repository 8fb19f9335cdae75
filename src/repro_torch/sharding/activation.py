"""Logical activation-sharding constraints.

Model code stays mesh-agnostic: it names the logical axes of an activation
(``"batch"``, ``"seq"``, ``"vocab"``, ...); a launcher binds logical names
to mesh axes around a sharded run.  With no binding (every single-card and
CPU path) ``constrain`` costs one dict check and returns its input itself.

With a binding, a ``DTensor`` input is redistributed to the bound
placements (JAX's ``with_sharding_constraint``); a plain tensor has no
placement to constrain and comes back as it is.  A bound run is a sharded
run: inside it a plain tensor that meets a ``DTensor`` (a RoPE table, a
mask, an ``arange`` of positions) is read as replicated on the
``DTensor``'s mesh (``implicit_replication``), as a JAX constant is
replicated over the mesh.
"""
from __future__ import annotations

import contextlib
from typing import Optional

_BINDING: dict[str, Optional[str | tuple[str, ...]]] = {}


@contextlib.contextmanager
def bind(mapping: dict[str, Optional[str | tuple[str, ...]]]):
    """Bind logical axis names -> mesh axes for the enclosed run, with
    plain tensors read as replicated beside a ``DTensor``."""
    from torch.distributed.tensor.experimental import implicit_replication
    global _BINDING
    old = _BINDING
    _BINDING = dict(mapping)
    try:
        with implicit_replication():
            yield
    finally:
        _BINDING = old


def constrain(x, *logical: Optional[str]):
    if not _BINDING:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.partition import P, placements
    if not isinstance(x, DTensor):
        return x
    spec = P(*[_BINDING.get(name) if name else None for name in logical])
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def standard_binding(dp_axes: tuple[str, ...], model_axis: str = "model",
                     seq_parallel: bool = True):
    return {"batch": dp_axes, "vocab": model_axis, "heads": model_axis,
            "ffn": model_axis, "seq": model_axis if seq_parallel else None}


def elementwise(fn, x):
    """``fn`` (elementwise) of ``x``; a ``DTensor`` runs it on its own
    shard and keeps its placements (for an op ``DTensor`` has no rule
    for, such as ``logsigmoid``'s backward).  A partial sum is reduced
    first, since ``fn`` is not linear."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return fn(x)
    pl = tuple(Replicate() if isinstance(q, Partial) else q
               for q in x.placements)
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def split_last(x, n: int):
    """``x.reshape(..., n, -1)``: the last dim split into ``n`` groups
    (heads).  A ``DTensor`` whose last dim is sharded over a mesh dim
    that does not divide ``n`` (8 KV heads on 16 model ranks) is gathered
    on that mesh dim first: ``DTensor`` cannot split an uneven shard, and
    GSPMD gathers there too."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = tuple(Replicate() if isinstance(q, Shard)
                   and q.dim == x.dim() - 1 and n % mesh.size(i) else q
                   for i, q in enumerate(x.placements))
        if pl != tuple(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:-1], n, -1)


def fsdp_gathered(w, model_axis: str = "model"):
    """A ``DTensor`` parameter whole over every mesh dim but ``model``
    (FSDP's all-gather before use); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = tuple(q if name == model_axis else Replicate()
               for name, q in zip(names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def merge_last(x, k: int):
    """``x`` with its last ``k`` dims flattened into one (heads back into
    features).  A ``DTensor`` has those dims gathered first and its
    gradient brought to the result's placements before the flatten's
    backward: a split inner dim cannot be flattened, nor the gradient
    unflattened, on every mesh size."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    flat = tuple(x.shape[:-k]) + (-1,)
    if not isinstance(x, DTensor):
        return x.reshape(flat)
    pl = tuple(Replicate() if isinstance(q, Shard) and q.dim >= x.dim() - k
               else q for q in x.placements)
    out = x.redistribute(x.device_mesh, pl).reshape(flat)
    return out.redistribute(out.device_mesh, out.placements)


def whole_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` unsplit (a time scan steps along it:
    a ``DTensor`` split there would gather it again at every step); a
    plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    d = dim % x.dim()
    pl = tuple(Replicate() if isinstance(q, Shard) and q.dim == d else q
               for q in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def repeat_kv(k, group: int):
    """GQA's K/V heads for every query head: ``repeat_interleave(k,
    group, dim=1)``.  On a ``DTensor`` each rank builds only its own
    heads: KV heads split over ``model`` repeat locally (a rank's query
    heads are its KV heads' groups), and KV heads replicated there (8 KV
    heads on 16 ranks) are picked for the rank's share of the query heads,
    their gradient a partial sum over ``model``; ``DTensor``'s own repeat
    would give every rank every head, and its backward cannot regroup an
    uneven head split."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if group == 1:
        return k
    if not isinstance(k, DTensor):
        return torch.repeat_interleave(k, group, dim=1)
    mesh = k.device_mesh
    hq = k.shape[1] * group
    out_pl, grad_pl, pick = [], [], None
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, k.placements)):
        n = mesh.size(i)
        if (pick is None and name == "model" and isinstance(p, Replicate)
                and n > 1 and hq % n == 0):
            pick = (mesh.get_local_rank(i), n)
            out_pl.append(Shard(1))
            grad_pl.append(Partial())
        else:
            out_pl.append(p)
            # A partial sum's gradient is the whole one on every rank.
            grad_pl.append(Replicate() if p.is_partial() else p)
    local = k.to_local(grad_placements=grad_pl)
    if pick is None:
        out = torch.repeat_interleave(local, group, dim=1)
    else:
        c, n = pick
        idx = (torch.arange(hq // n, device=local.device)
               + c * (hq // n)) // group
        out = local.index_select(1, idx)
    shape = torch.Size((k.shape[0], hq) + tuple(k.shape[2:]))
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape, stride=_contiguous(shape))


def _as_dtensor(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _contiguous(shape) -> tuple[int, ...]:
    """A contiguous tensor's strides for ``shape`` (no tensor made: a
    dispatch mode counting the step would see one)."""
    strides, step = [], 1
    for d in reversed(tuple(shape)):
        strides.append(step)
        step *= max(d, 1)
    return tuple(reversed(strides))


def _wrap(local, mesh, pl, shape):
    import torch
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous(shape))


def matmul(x, w, model_axis: str = "model"):
    """``x @ w`` for ``x`` [..., d_in] and ``w`` [d_in, d_out], as each
    rank of a ``DTensor`` run computes it on its shards.  On ``model``
    (Megatron's rules): ``w`` split by d_out gives an output split there,
    ``x`` gathered whole (a sequence-parallel stream's all-gather); split
    by d_in, it meets ``x`` split the same way and leaves a partial sum;
    whole, ``x`` keeps its rows' split.  On the data axes ``w`` is
    gathered whole (FSDP) and ``x`` keeps its rows there, ``w``'s
    gradient a partial sum.  Plain tensors multiply as ever.
    (``DTensor``'s own rule flattens the leading dims, which some PyTorch
    versions refuse when two of them are split.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not (isinstance(x, DTensor) or isinstance(w, DTensor)):
        return x @ w
    mesh = (w if isinstance(w, DTensor) else x).device_mesh
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    n = x.dim()
    xp, wp, op, xg, wg = [], [], [], [], []
    for name, px, pw in zip(mesh.mesh_dim_names, x.placements,
                            w.placements):
        rows = isinstance(px, Shard) and px.dim < n - 1
        keep = rows or px.is_partial()
        if name == model_axis and isinstance(pw, Shard) and pw.dim == 1:
            xp.append(Replicate()), wp.append(pw), op.append(Shard(n - 1))
            xg.append(Partial()), wg.append(pw)
        elif name == model_axis and isinstance(pw, Shard):
            xp.append(Shard(n - 1)), wp.append(pw), op.append(Partial())
            xg.append(Shard(n - 1)), wg.append(pw)
        else:
            xp.append(px if keep else Replicate()), wp.append(Replicate())
            op.append(px if keep else Replicate())
            xg.append(px if rows else Replicate())
            wg.append(Partial() if keep else Replicate())
    xl = x.redistribute(mesh, xp).to_local(grad_placements=xg)
    wl = w.redistribute(mesh, wp).to_local(grad_placements=wg)
    return _wrap(xl @ wl, mesh, op, tuple(x.shape[:-1]) + (w.shape[1],))


def einsum(eq: str, *operands):
    """``torch.einsum(eq, *operands)``.  On ``DTensor``s (``eq`` with an
    explicit ``->``, no ellipsis) each rank runs the same call on its local
    shards, and the output is split where its indices were: on each mesh
    dim the index that the first operand split there (a batch index such
    as b or h), the other operands split the same way, or whole where
    they lack it (their gradients then a partial sum).  A contracted index
    split on a mesh dim is refused: a rank's sum would be a partial one.
    ``DTensor``'s own einsum flattens the batch indices into one dim,
    which PyTorch 2.11 refuses when two of them are split."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not any(isinstance(t, DTensor) for t in operands):
        return torch.einsum(eq, *operands)
    subs, out = eq.replace(" ", "").split("->")
    subs = subs.split(",")
    if "." in eq or len(subs) != len(operands):
        raise ValueError(f"activation.einsum: {eq!r} on {len(operands)} "
                         f"operands")
    mesh = next(t for t in operands if isinstance(t, DTensor)).device_mesh
    ts = [_as_dtensor(t, mesh) for t in operands]
    size = {}
    for sub, t in zip(subs, ts):
        for c, n in zip(sub, t.shape):
            size[c] = max(size.get(c, 1), n)
    pls, grads, out_pl = [[] for _ in ts], [[] for _ in ts], []
    for i in range(mesh.ndim):
        split = [sub[p.dim] for sub, t in zip(subs, ts)
                 for p in (t.placements[i],) if isinstance(p, Shard)]
        summed = [c for c in split if c not in out]
        if summed:
            raise ValueError(
                f"activation.einsum: {eq!r} contracts index {summed[0]!r}, "
                f"split over mesh dim {mesh.mesh_dim_names[i]!r}")
        c = split[0] if split else None
        for k, sub in enumerate(subs):
            if c is not None and c in sub:
                pls[k].append(Shard(sub.index(c)))
                grads[k].append(Shard(sub.index(c)))
            else:
                pls[k].append(Replicate())
                grads[k].append(Partial() if c is not None else Replicate())
        out_pl.append(Shard(out.index(c)) if c is not None else Replicate())
    local = torch.einsum(eq, *(t.redistribute(mesh, pl).to_local(
        grad_placements=g) for t, pl, g in zip(ts, pls, grads)))
    return _wrap(local.contiguous(), mesh, out_pl, [size[c] for c in out])


def last_whole(fn, *xs):
    """``fn(*xs)`` for a function that works along the last dim only (a
    concat, a pad) of operands with the same leading dims.  On
    ``DTensor``s each rank runs it on its own rows (the first operand's
    splits of the leading dims) with every last dim whole, and the output
    keeps those rows (for an op ``DTensor`` refuses, such as ``F.pad`` on
    PyTorch 2.11)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not any(isinstance(x, DTensor) for x in xs):
        return fn(*xs)
    mesh = next(x for x in xs if isinstance(x, DTensor)).device_mesh
    xs = [_as_dtensor(x, mesh) for x in xs]
    n = xs[0].dim()
    pl = tuple(p if isinstance(p, Shard) and p.dim < n - 1 else Replicate()
               for p in xs[0].placements)
    out = fn(*(x.redistribute(mesh, pl).to_local(grad_placements=pl)
               for x in xs))
    return _wrap(out, mesh, pl, tuple(xs[0].shape[:-1]) + (out.shape[-1],))


def by_heads(fn, q, *heads, mask=None):
    """``fn(q, *heads, mask)`` for attention-like work that is independent
    per batch row and head: ``q`` and ``heads`` [B, H, ...]; ``mask``
    None, [Tq, Tk] or per row [B, Tq, Tk].  On ``DTensor``s each rank runs
    ``fn`` on its rows and heads (``q``'s splits of dims 0 and 1, the
    other dims whole; a per-row mask on its rows) and the output, [B, H,
    ...], keeps them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(q, DTensor):
        return fn(q, *heads, mask)
    mesh = q.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
               for p in q.placements)

    def local(t, placements):
        return _as_dtensor(t, mesh).redistribute(mesh, placements).to_local()

    if mask is not None:
        mask = local(mask, tuple(
            p if mask.dim() == 3 and isinstance(p, Shard) and p.dim == 0
            else Replicate() for p in pl))
    out = fn(local(q, pl), *(local(t, pl) for t in heads), mask)
    return _wrap(out, mesh, pl, tuple(q.shape[:2]) + tuple(out.shape[2:]))
