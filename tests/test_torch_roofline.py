"""The port's roofline module and the serving bench's analytic byte
counters against the JAX package's, on the CPU.

The byte helpers (``leaf_nbytes``, ``kv_page_bytes``, ``kv_slot_bytes``,
``dense_kv_bytes``) and ``bench_serving.analytic_step_bytes`` /
``analytic_slot_bytes`` run on the port's cache trees as ``meta`` tensors
and on real tensors, and must equal JAX's on ``jax.eval_shape`` trees of
the same reduced configs: dense and paged MHA caches, int8 and fp8 pools,
every MLA latent layout (dense, paged, int8, fp8), the recurrent state and
whisper's cross-attention cache.  ``roofline()`` must equal JAX's on the
same cell once the port's H100 constants are monkeypatched to JAX's: that
holds the formulas apart from the constants.
"""
from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from benchmarks import bench_serving as jbench  # noqa: E402
from benchmarks import roofline as jroof  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.benchmarks import bench_serving as tbench  # noqa: E402
from repro_torch.benchmarks import roofline as troof  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

ARCHS = ("olmo-1b", "deepseek-v2-lite-16b", "recurrentgemma-2b",
         "whisper-tiny", "xlstm-125m")
LAYOUTS = [(False, "off"), (True, "off"), (True, "int8"), (True, "fp8")]
B, MAX_LEN, PS = 3, 64, 8


def _cfgs(arch):
    return (jconfigs.reduced(jconfigs.get(arch)),
            tconfigs.reduced(tconfigs.get(arch)))


@pytest.mark.parametrize("paged,kv_quant", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_byte_helpers_match_jax(arch, paged, kv_quant):
    jcfg, tcfg = _cfgs(arch)
    kw = dict(paged=paged, page_size=PS, kv_quant=kv_quant)
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, B, MAX_LEN, **kw))
    meta = troof.abstract_cache(tcfg, B, MAX_LEN, **kw)
    real = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu", **kw)
    want = [f(jcache) for f in (jroof.kv_page_bytes, jroof.kv_slot_bytes,
                                jroof.dense_kv_bytes)]
    for cache in (meta, real):
        got = [f(cache) for f in (troof.kv_page_bytes, troof.kv_slot_bytes,
                                  troof.dense_kv_bytes)]
        assert got == want
    # xlstm-125m holds recurrent state only: no KV byte to count.
    assert (sum(want) > 0) is (arch != "xlstm-125m")
    jleaves = jax.tree.leaves(jcache)
    assert (sum(jroof.leaf_nbytes(x) for x in jleaves)
            == sum(troof.leaf_nbytes(x) for x in _leaves(real))
            == sum(troof.leaf_nbytes(x) for x in _leaves(meta)))


def _leaves(tree):
    from repro_torch.core import tree as tree_mod
    return tree_mod.leaves(tree)


@pytest.mark.parametrize("paged,kv_quant", LAYOUTS)
@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b",
                                  "recurrentgemma-2b"])
def test_analytic_bench_bytes_match_jax(arch, paged, kv_quant):
    jcfg, tcfg = _cfgs(arch)
    kw = dict(batch=B, max_len=MAX_LEN, page_size=PS)
    lens = [5, 17, 40]
    assert (tbench.analytic_step_bytes(tcfg, live_lens=lens, paged=paged,
                                       kv_quant=kv_quant, **kw)
            == jbench.analytic_step_bytes(jcfg, live_lens=lens, paged=paged,
                                          kv_quant=kv_quant, **kw))
    if paged:
        assert (tbench.analytic_slot_bytes(tcfg, kv_quant=kv_quant, **kw)
                == jbench.analytic_slot_bytes(jcfg, kv_quant=kv_quant, **kw))


def _cell(kind: str, coll) -> dict:
    cell = {"arch": "olmo-1b", "shape": f"{kind}_x", "mesh": "single",
            "variant": "baseline", "kind": kind, "status": "ok",
            "n_devices": 256, "flops_per_device": 3.3e12,
            "bytes_per_device": 1.9e10, "model_flops_est": 3.0e14,
            "collective_bytes_per_device": coll,
            "memory_analytic": {"params_per_device": 147095552,
                                "cache_per_device": 2147483648,
                                "total_per_device": 2294579200}}
    if kind == "train":
        cell["memory_analytic"] = {"params_per_device": 9193472,
                                   "opt_per_device": 36773892,
                                   "total_per_device": 45967364}
    return cell


@pytest.mark.parametrize("coll", [{"all-gather": 2e9, "total": 2e9},
                                  {"total": 1e6}, {}])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_formulas_match_jax(kind, coll, monkeypatch):
    monkeypatch.setattr(troof, "PEAK_FLOPS_BF16", jroof.PEAK_FLOPS_BF16)
    monkeypatch.setattr(troof, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(troof, "NVLINK_BW", jroof.ICI_BW)
    cell = _cell(kind, coll)
    assert troof.roofline(dict(cell)) == jroof.roofline(dict(cell))
    err = dict(cell, status="error")
    assert troof.roofline(err) is None is jroof.roofline(err)


def test_unmeasured_collective_term_is_not_zero():
    cell = _cell("decode", None)
    r = troof.roofline(cell)
    assert r["t_collective"] is None
    assert "no collective bytes" in r["collective_term"]
    assert r["dominant"] == "memory"
    assert r["t_memory"] == cell["bytes_per_device"] / 3.35e12
    assert r["t_compute"] == cell["flops_per_device"] / 989e12


def test_collective_term_is_measured_from_the_records_bytes():
    """A record of the sharded dry run carries collective bytes: the term
    is their total over NVLink, and it can dominate."""
    cell = _cell("train", {"all-reduce": 4e12, "total": 4e12})
    r = troof.roofline(cell)
    assert r["t_collective"] == 4e12 / 450e9
    assert "collective_term" not in r
    assert r["dominant"] == "collective"


def test_h100_constants_and_no_tpu_constant():
    assert (troof.PEAK_FLOPS_BF16, troof.HBM_BW, troof.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert troof.CARD == "NVIDIA H100 80GB HBM3"
    assert troof.POWER_LIMIT == "700.00 W"
    assert troof.DRYRUN_DIR.name == "dryrun_torch"
    from pathlib import Path
    src = Path(troof.__file__).resolve().parents[1]
    for path in src.rglob("*.py"):
        text = path.read_text()
        for tpu in ("197e12", "819e9", "50e9 * 4", "v5e"):
            assert tpu not in text, (path, tpu)


def test_table_and_summary_read_the_ports_records(tmp_path, monkeypatch):
    d = tmp_path / "single"
    d.mkdir()
    (d / "olmo-1b__decode_32k__baseline.json").write_text(json.dumps(
        dict(_cell("decode", None), shape="decode_32k")))
    (d / "olmo-1b__long_500k__baseline.json").write_text(json.dumps(
        {"arch": "olmo-1b", "shape": "long_500k", "status": "skipped",
         "reason": "pure full-attention arch"}))
    monkeypatch.setattr(troof, "DRYRUN_DIR", tmp_path)
    rows = troof.summary_rows()
    assert len(rows) == 1 and "t_coll=unmeasured" in rows[0]
    assert rows[0].startswith("roofline/olmo-1b/decode_32k,")
    table = troof.table()
    assert "H100" in table[0] and "unmeasured" in table[-2]
    assert "N/A" in table[-1]
    monkeypatch.setattr(troof, "DRYRUN_DIR", tmp_path / "none")
    with pytest.raises(FileNotFoundError):
        troof.summary_rows()
