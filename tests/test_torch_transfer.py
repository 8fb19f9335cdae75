"""The leaf-table ``page_transfer`` of the port on the CPU: one call moves
a page through every pool leaf of an adoption.

* ``ops.page_transfer_leaves`` on CPU tensors (the plain version, leaf by
  leaf) against a loop of ``ref.page_transfer`` and JAX's oracle, bitwise,
  on bf16, int8, fp8, f32-scale and MLA-latent leaves with -1 lanes,
  destinations past a pool and duplicate destinations; its contract.
* The descriptor table the card's launch takes (``kernels/page_transfer
  .leaf_tables``), built here from CPU tensors: each leaf's access width
  (16, 4 or 1 byte) from its pointers' and row's alignment, the chunks at
  the 64-leaf cap; and a byte-for-byte emulation of the
  launch over the table (``ctypes.memmove`` on the descriptors' pointers,
  the kernel's lane rules) against the plain version.
* ``cache.copy_pages_across`` and ``adopt_pages`` make one
  ``page_transfer_leaves`` call an adoption and still equal JAX's page
  moves bitwise on reduced OLMo bf16 and int8 caches and an MLA cache.
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import page_transfer as kxfer  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from test_torch_disagg import (_filled_cache, _jax_pool_bytes,  # noqa: E402
                               _mla, _olmo, _pool, _pool_bytes)

# The leaves an adoption moves, at small page counts: OLMo's K/V rows
# (bf16, int8, fp8) and f32 scales, MLA's latent rows and scales, and an
# int8 row of odd width.
LEAVES = {"bf16": ((4, 8, 16), ml_dtypes.bfloat16),
          "int8": ((4, 8, 16), np.int8),
          "fp8": ((4, 8, 16), ml_dtypes.float8_e4m3fn),
          "f32_scales": ((4, 8), np.float32),
          "mla_latent": ((8, 640), ml_dtypes.bfloat16),
          "mla_scales": ((8,), np.float32),
          "int8_odd": ((3, 5), np.int8)}
# -1 on either side, destinations past the smallest pool (6) and the
# largest (9), a source past the pool (clipped), destination 2 written by
# lanes 0 and 5 (the later wins), 4 by lanes 6 and 7 (-1 source: 6 wins).
SRC_IDS = np.array([0, -1, 3, 5, 11, 6, 2, -1, 4], np.int32)
DST_IDS = np.array([2, 1, -1, 9, 0, 2, 4, 4, 7], np.int32)


def _bits(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _pairs(seed):
    """(host pools, port pairs): one (src, dst) per leaf, page counts
    7..9 (src) and 6..8 (dst) by leaf."""
    rng = np.random.default_rng(seed)
    host, pairs = [], []
    for i, (row, dtype) in enumerate(LEAVES.values()):
        src = _pool(rng, 7 + i % 3, row, dtype)
        dst = _pool(rng, 6 + i % 3, row, dtype)
        host.append((src, dst))
        pairs.append((convert.to_tensor(src, "cpu"),
                      convert.to_tensor(dst, "cpu")))
    return host, pairs


def test_page_transfer_leaves_match_a_loop_of_plain_and_jax():
    host, pairs = _pairs(0)
    loop = [(s, d.clone()) for s, d in pairs]
    for s, d in loop:
        ref.page_transfer(s, d, torch.from_numpy(SRC_IDS),
                          torch.from_numpy(DST_IDS))
    out = ops.page_transfer_leaves(pairs, SRC_IDS, DST_IDS)
    assert all(o is d for o, (_, d) in zip(out, pairs))
    for (src, dst), got, (_, want) in zip(host, out, loop):
        assert _bits(got) == _bits(want)
        jax_want = np.asarray(jref.page_transfer(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(SRC_IDS),
            jnp.asarray(DST_IDS)))
        assert _bits(got) == jax_want.tobytes()


def test_page_transfer_leaves_contract():
    _, pairs = _pairs(1)
    a = torch.zeros((4, 2, 8))
    with pytest.raises(ValueError, match=r"pool rows do not match \(leaf 1\)"):
        ops.page_transfer_leaves([pairs[0], (a, torch.zeros((4, 2, 4)))],
                                 [0], [0])
    with pytest.raises(ValueError, match="matching 1-D"):
        ops.page_transfer_leaves(pairs, [0, 1], [0])
    with pytest.raises(ValueError, match=r"share storage \(leaf 1\)"):
        ops.page_transfer_leaves([pairs[0], (a[:2], a[2:])], [0], [1])
    # A destination that is another leaf's source, or another leaf's
    # destination, would race in one launch.
    b, c = torch.ones((4, 2, 8)), torch.full((4, 2, 8), 2.0)
    with pytest.raises(ValueError, match="overlaps another pool"):
        ops.page_transfer_leaves([(a, b), (b, c)], [0], [1])
    with pytest.raises(ValueError, match="overlaps another pool"):
        ops.page_transfer_leaves([(a, b), (c, b[1:])], [0], [1])
    # One source may feed several destinations.
    ops.page_transfer_leaves([(a, b), (a, c)], [0], [1])
    assert (b[1] == 0).all() and (c[1] == 0).all() and (c[0] == 2).all()
    assert ops.page_transfer_leaves([], [0], [1]) == []
    keep = [d.clone() for _, d in pairs]
    empty = torch.zeros(0, dtype=torch.int32)
    assert ops.page_transfer_leaves(pairs, empty, empty) == \
        [d for _, d in pairs]
    assert all(torch.equal(k, d) for k, (_, d) in zip(keep, pairs))
    with pytest.raises(ValueError, match="impl"):
        ops.page_transfer_leaves(pairs, [1], [2], impl="pallas")


def _view(shape, dtype, byte_offset):
    """A contiguous ``shape`` view ``byte_offset`` bytes past a 16-byte
    aligned base."""
    n = int(np.prod(shape)) * dtype.itemsize
    raw = torch.zeros(n + byte_offset + 16, dtype=torch.uint8)
    lead = (-raw.data_ptr()) % 16 + byte_offset
    return raw[lead:lead + n].view(dtype).view(shape)


@pytest.mark.parametrize("row,dtype,offset,width", [
    ((16, 8), torch.bfloat16, 0, 16),        # 256 B rows, aligned
    ((8,), torch.float32, 0, 16),            # 32 B scale rows
    ((3,), torch.float32, 0, 4),             # 12 B: words
    ((7,), torch.bfloat16, 2, 1),            # 14 B, 2 bytes off: bytes
    ((16, 8), torch.bfloat16, 2, 1),         # aligned size, 2 bytes off
    ((16, 8), torch.bfloat16, 4, 4),         # 4 bytes off: words
    ((3, 5), torch.int8, 0, 1),              # odd int8 widths: bytes
    ((1, 3), torch.int8, 0, 1),
    ((4, 4), torch.int8, 0, 16),
])
def test_leaf_table_width(row, dtype, offset, width):
    src = _view((5,) + row, dtype, 0)
    dst = _view((4,) + row, dtype, offset)
    (table,) = kxfer.leaf_tables([(src, dst)])
    (leaf,) = table
    row_bytes = int(np.prod(row)) * dtype.itemsize
    assert (leaf.src, leaf.dst) == (src.data_ptr(), dst.data_ptr())
    assert (leaf.row_bytes, leaf.num_src, leaf.num_dst) == (row_bytes, 5, 4)
    assert leaf.width == width
    # The card reads 48-byte descriptors (csrc/page_transfer.cu's Leaf).
    assert ctypes.sizeof(table) == 48
    # An OLMo-1B row (64 KB, bf16) takes 16-byte accesses.
    big = torch.zeros((1, 16, 16, 128), dtype=torch.bfloat16)
    (leaf,) = kxfer.leaf_tables([(big, big.clone())])[0]
    assert (leaf.row_bytes, leaf.width) == (65536, 16)


@pytest.mark.parametrize("n", [1, 64, 65, 130])
def test_leaf_table_chunks_at_the_cap(n):
    pools = [(torch.zeros((3, 4)), torch.zeros((2, 4))) for _ in range(n)]
    tables = kxfer.leaf_tables(pools)
    cap = kxfer.MAX_LEAVES
    assert [len(t) for t in tables] == [cap] * (n // cap) + \
        ([n % cap] if n % cap else [])
    assert [leaf.dst for t in tables for leaf in t] == \
        [d.data_ptr() for _, d in pools]
    # Empty rows or an empty pool move nothing and take no descriptor.
    empty = [(torch.zeros((3, 0)), torch.zeros((2, 0))),
             (torch.zeros((0, 4)), torch.zeros((2, 4))),
             (torch.zeros((3, 4)), torch.zeros((0, 4)))]
    assert kxfer.leaf_tables(empty) == []


def _emulate_launch(table, src_ids, dst_ids):
    """The card's launch over ``table`` on CPU memory: per leaf and lane,
    the kernel's rules (drop -1 lanes and destinations past the leaf's
    pool, clip sources, skip lanes a later live lane supersedes), then the
    row copied through the descriptors' pointers, whose rows and bases
    are aligned to the leaf's access width."""
    n = len(src_ids)
    for leaf in table:
        assert (leaf.src | leaf.dst | leaf.row_bytes) % leaf.width == 0
        for lane in range(n):
            s, d = int(src_ids[lane]), int(dst_ids[lane])
            if s < 0 or d < 0 or d >= leaf.num_dst:
                continue
            if any(dst_ids[j] == d and src_ids[j] >= 0
                   for j in range(lane + 1, n)):
                continue
            s = min(s, leaf.num_src - 1)
            ctypes.memmove(leaf.dst + d * leaf.row_bytes,
                           leaf.src + s * leaf.row_bytes, leaf.row_bytes)


def test_leaf_table_drives_the_copy():
    """The descriptors' pointers, row bytes and pool sizes move every
    leaf as the plain version does (a misaligned view included)."""
    _, pairs = _pairs(2)
    flat = _view((4 * 7 + 1,), torch.bfloat16, 0)
    flat.copy_(torch.arange(29, dtype=torch.bfloat16))
    pairs.append((torch.randn(5, 7).to(torch.bfloat16), flat[1:].view(4, 7)))
    want = [d.clone() for _, d in pairs]
    for (s, _), w in zip(pairs, want):
        ref.page_transfer(s, w, torch.from_numpy(SRC_IDS),
                          torch.from_numpy(DST_IDS))
    (table,) = kxfer.leaf_tables(pairs)
    assert {leaf.width for leaf in table} == {16, 1}
    _emulate_launch(table, SRC_IDS, DST_IDS)
    for (_, got), w in zip(pairs, want):
        assert _bits(got) == _bits(w)


CACHES = {"olmo_bf16": (_olmo, "off", 4), "olmo_int8": (_olmo, "int8", 8),
          "mla": (_mla, "off", 2)}


@pytest.mark.parametrize("family", sorted(CACHES))
def test_adoption_is_one_call_and_matches_jax(family, monkeypatch):
    """``copy_pages_across`` and ``adopt_pages`` each make one
    ``page_transfer_leaves`` call holding every pool leaf of the cache
    (two layers: 4 for bf16 K/V, 8 with int8 scales, 2 MLA latent
    pools), and their pools equal JAX's bitwise."""
    make, quant, n_leaves = CACHES[family]
    jcfg, tcfg = make(jconfigs), make(tconfigs)
    calls = []
    real = ops.page_transfer_leaves

    def spy(pairs, *a, **kw):
        calls.append(len(pairs))
        return real(pairs, *a, **kw)

    monkeypatch.setattr(ops, "page_transfer_leaves", spy)
    jsrc, jdst = (_filled_cache(jcfg, quant, 7, seed) for seed in (3, 4))
    tsrc, tdst = (convert.cache_from_jax(jax.tree.map(np.asarray, c), tcfg,
                                         device="cpu") for c in (jsrc, jdst))
    # Ids inside the pools: JAX's copy of a stacked [G, P] leaf moves
    # G * P flattened rows, so an id past a pool lands in the next
    # group's there, where the port drops it (the kernel's contract).
    src_ids, dst_ids = [3, -1, 6, 0, 2, 5], [1, 4, 0, -1, 1, 6]
    jout, jbytes = jlm.copy_pages_across(jsrc, jdst, jnp.asarray(src_ids),
                                         jnp.asarray(dst_ids),
                                         use_pallas=False)
    tout, tbytes = tlm.copy_pages_across(tsrc, tdst, src_ids, dst_ids)
    assert calls == [n_leaves] and tbytes == jbytes > 0
    for (n1, a), (n2, b) in zip(_pool_bytes(tout),
                                _jax_pool_bytes(jout, tcfg)):
        assert n1 == n2 and a.tobytes() == b.tobytes(), n1
    # Adopt: a -1 lane and an id past the pool (its last row).
    pages, targets = [6, 1, 0, 2], [4, -1, 2, 9]
    rows = tlm.export_pages(tsrc, pages)
    jfinal = jlm.adopt_pages(jout, jlm.export_pages(jsrc, jnp.asarray(pages)),
                             jnp.asarray(targets))
    tfinal = tlm.adopt_pages(tout, rows, targets)
    assert calls == [n_leaves, n_leaves]
    for (n1, a), (n2, b) in zip(_pool_bytes(tfinal),
                                _jax_pool_bytes(jfinal, tcfg)):
        assert n1 == n2 and a.tobytes() == b.tobytes(), n1


def test_adoption_checks_every_leaf_before_writing():
    """A leaf mismatch in the last layer raises before any layer is
    written: one call moves all leaves, after every check."""
    cfg = _olmo(tconfigs)
    a = tlm.init_cache(cfg, 2, 32, paged=True, page_size=8, num_pages=5,
                       device="cpu")
    b = tlm.init_cache(cfg, 2, 32, paged=True, page_size=8, num_pages=5,
                       device="cpu")
    for _, layout, layer in tcache.iter_layers(a):
        for name in tcache.pool_leaves(layout):
            layer[name].fill_(1.0)
    rows = tlm.export_pages(a, [0])
    rows["layers/1"]["v_pages"] = rows["layers/1"]["v_pages"][:, :1]
    before = _pool_bytes(b)
    with pytest.raises(ValueError, match="adopt_pages: pool leaf 'v_pages' "
                                         "of layer layers/1"):
        tlm.adopt_pages(b, rows, [0])
    assert [x.tobytes() for _, x in _pool_bytes(b)] == \
        [x.tobytes() for _, x in before]
