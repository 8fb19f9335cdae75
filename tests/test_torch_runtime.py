"""The port's training runtime against the JAX package's, on the CPU.

Checkpoints: the cases of tests/test_runtime.py (round trip with bf16
leaves bitwise, ``LATEST`` and GC, structure validation, async overlap, a
partial write never corrupting ``LATEST``), the async snapshot taken before
an in-place update, and the on-disk layout shared with JAX's writer: for a
flat list of leaves (float32, int32, bfloat16; numpy for JAX's writer,
the same bits as tensors for the port's) every ``arr_i.npy`` file and
every leaf's metadata equal JAX's, and each package restores the other's
checkpoint bitwise.

The elastic queue: the cases of tests/test_runtime.py (disjoint drain, a
dead worker's shard reclaimed, stragglers, a join mid-run), each run by
both packages under the same clock, their claim traces equal.

The trainer: finite losses, crash and restart resuming at JAX's step (4),
and, started from JAX's trainer's bf16 parameters and AdamW state, the
port's per-step losses within 1e-3 relative of JAX's over the same shards
(a bf16 model: the two frameworks round its activations in other orders,
and an update that lands on a rounding edge may round the other way;
measured at most 5.1e-4 over the 12 steps, with no drift).
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.runtime import checkpoint as jck  # noqa: E402
from repro.runtime import elastic as jel  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.runtime import checkpoint as ck  # noqa: E402
from repro_torch.runtime import elastic as el  # noqa: E402
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402


# ---------------------------------------------------------------------------
# Checkpoint
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 3), generator=g),
            "b": {"c": torch.arange(7, dtype=torch.int32),
                  "d": [torch.randn((5, 2), generator=g).bfloat16(),
                        torch.tensor(seed, dtype=torch.int32)]}}


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _assert_bitwise(a, b) -> None:
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_checkpoint_roundtrip_bitwise(tmp_path):
    t = _tree()
    ck.save(tmp_path, 5, t)
    restored, step = ck.restore(tmp_path, t)
    assert step == 5
    assert isinstance(restored["b"]["d"], list)
    _assert_bitwise(t, restored)


def test_checkpoint_latest_pointer_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        ck.save(tmp_path, s, t, keep=2)
    assert ck.latest_step(tmp_path) == 4
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]


def test_checkpoint_structure_validation(tmp_path):
    ck.save(tmp_path, 1, _tree())
    with pytest.raises(ValueError):
        ck.restore(tmp_path, {"a": torch.zeros((4, 3))})     # missing leaves
    with pytest.raises(ValueError):
        bad = _tree()
        bad["a"] = torch.zeros((5, 3))                       # wrong shape
        ck.restore(tmp_path, bad)
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path / "none", _tree())


def test_async_checkpointer_overlap_and_snapshot(tmp_path):
    acp = ck.AsyncCheckpointer(tmp_path, keep=3)
    t = _tree(10)
    acp.save(10, t)
    want = {"a": t["a"].clone()}
    t["a"].add_(1.0)                 # the optimizer writes in place
    acp.save(20, _tree(20))
    acp.wait()
    assert ck.latest_step(tmp_path) == 20
    old, step = ck.restore(tmp_path, _tree(), step=10)
    assert step == 10
    np.testing.assert_array_equal(old["a"].numpy(), want["a"].numpy())


def test_partial_write_never_corrupts_latest(tmp_path):
    t = _tree()
    ck.save(tmp_path, 1, t)
    (tmp_path / ".tmp_step_00000002").mkdir()       # a crashed write
    assert ck.latest_step(tmp_path) == 1
    _, step = ck.restore(tmp_path, t)
    assert step == 1


def _flat_numpy():
    r = np.random.default_rng(3)
    return [r.normal(size=(6, 5)).astype(np.float32),
            np.arange(11, dtype=np.int32),
            r.normal(size=(4, 8)).astype(ml_dtypes.bfloat16),
            np.asarray(7, np.int32),
            r.normal(size=(3,)).astype(np.float32)]


def test_checkpoint_files_equal_jax_writer(tmp_path):
    leaves = _flat_numpy()
    like = [convert.to_tensor(a, "cpu") for a in leaves]     # same bits
    jck.save(tmp_path / "jax", 3, leaves)
    ck.save(tmp_path / "port", 3, like)
    for sub in ("jax", "port"):
        assert (tmp_path / sub / "LATEST").read_text() == "step_00000003"
    jd, td = tmp_path / "jax" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    jmeta = json.loads((jd / "meta.json").read_text())
    tmeta = json.loads((td / "meta.json").read_text())
    assert tmeta["step"] == jmeta["step"] == 3
    assert tmeta["leaves"] == jmeta["leaves"]
    for i in range(len(leaves)):
        assert (td / f"arr_{i}.npy").read_bytes() \
            == (jd / f"arr_{i}.npy").read_bytes()

    # Each package restores the other's checkpoint bitwise.
    got, _ = ck.restore(tmp_path / "jax", like)
    _assert_bitwise(got, like)
    back, _ = jck.restore(tmp_path / "port", [jnp.asarray(a) for a in leaves])
    for a, b in zip(back, leaves):
        assert np.asarray(a).dtype == b.dtype
        assert np.asarray(a).tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Elastic work queue: both packages, one clock, equal claim traces
# ---------------------------------------------------------------------------

def _drain(pkg):
    shared = {}
    sync = pkg.make_shared_fold_sync(shared)
    q = pkg.make_queue(num_shards=6, num_workers=2)
    w1, w2 = pkg.Worker(1, q, sync), pkg.Worker(2, q, sync)
    trace = []
    for t in range(40):
        for w in (w1, w2):
            w.heartbeat(t)
            s = w.try_claim_shard(t)
            trace.append((t, w.id, s))
            if s is not None:
                w.complete_shard(s)
        if w1.done() and w2.done():
            break
    return trace


def _dead_worker(pkg):
    shared = {}
    sync = pkg.make_shared_fold_sync(shared)
    q = pkg.make_queue(num_shards=2, num_workers=2)
    w1 = pkg.Worker(1, q, sync, stale_timeout=50)
    w2 = pkg.Worker(2, q, sync, stale_timeout=50)
    trace = [("w1", w1.try_claim_shard(0))]
    s2 = w2.try_claim_shard(1)
    trace.append(("w2", s2))
    if s2 is not None:
        w2.complete_shard(s2)
    trace.append(("locked", w2.try_claim_shard(2)))
    trace.append(("reclaimed", w2.reclaim_stale(100)))
    s3 = w2.try_claim_shard(101)
    trace.append(("w2 again", s3))
    w2.complete_shard(s3)
    trace.append(("done", w2.done()))
    return trace


def _stragglers(pkg):
    shared = {}
    sync = pkg.make_shared_fold_sync(shared)
    q = pkg.make_queue(4, 3)
    w1, w2 = pkg.Worker(1, q, sync), pkg.Worker(2, q, sync)
    w1.heartbeat(100)
    w2.heartbeat(10)
    return [w1.stragglers(now=100, lag=50), w2.stragglers(now=200, lag=50),
            w1.stragglers(now=100, lag=95)]


def _join_mid_run(pkg):
    shared = {}
    sync = pkg.make_shared_fold_sync(shared)
    q = pkg.make_queue(num_shards=5, num_workers=4)
    w1 = pkg.Worker(1, q, sync)
    s = w1.try_claim_shard(0)
    trace = [(0, 1, s)]
    w1.complete_shard(s)
    w3 = pkg.Worker(3, w1.state, sync)
    for t in range(1, 20):
        for w in (w1, w3):
            sh = w.try_claim_shard(t)
            trace.append((t, w.id, sh))
            if sh is not None:
                w.complete_shard(sh)
        if w1.done():
            break
    return trace


def test_two_workers_drain_queue_disjointly_as_jax():
    trace = _drain(el)
    assert trace == _drain(jel)
    got = {1: [], 2: []}
    for _, wid, s in trace:
        if s is not None:
            got[wid].append(s)
    assert sorted(got[1] + got[2]) == list(range(6))
    assert not (set(got[1]) & set(got[2]))


def test_dead_worker_shard_reclaimed_as_jax():
    trace = _dead_worker(el)
    assert trace == _dead_worker(jel)
    d = dict(trace)
    assert d["w1"] is not None and d["locked"] is None
    assert d["reclaimed"] >= 1 and d["w2 again"] == d["w1"] and d["done"]


def test_straggler_detection_as_jax():
    got = _stragglers(el)
    assert got == _stragglers(jel)
    assert got[0] == [2]


def test_elastic_join_mid_run_as_jax():
    trace = _join_mid_run(el)
    assert trace == _join_mid_run(jel)
    assert sorted(s for _, _, s in trace if s is not None) == list(range(5))


def test_queue_lives_on_the_host():
    q = el.make_queue(num_shards=3, num_workers=2)
    for t in tree.leaves(q.board) + [q.heartbeats.counts, q.completed.member]:
        assert t.device.type == "cpu"
    with pytest.raises(ValueError):
        el.Worker(0, q, el.make_shared_fold_sync({}))


# ---------------------------------------------------------------------------
# Fault-tolerant trainer
# ---------------------------------------------------------------------------

def _tiny(tmp_path, steps=12, pkg="port"):
    c = tconfigs if pkg == "port" else jconfigs
    cfg = c.reduced(c.get("olmo-1b"), d_model=32, vocab=128)
    dc = (DataConfig if pkg == "port" else JDataConfig)(
        vocab_size=cfg.vocab_size, seq_len=16, batch_size=2,
        shard_size_batches=2)
    tc = (TrainerConfig if pkg == "port" else jtrainer.TrainerConfig)(
        steps=steps, checkpoint_every=4, checkpoint_dir=str(tmp_path),
        shard_timeout=50)
    return cfg, dc, tc


def test_trainer_runs_and_loss_finite(tmp_path):
    cfg, dc, tc = _tiny(tmp_path)
    q = el.make_queue(num_shards=8, num_workers=1)
    w = el.Worker(1, q, el.make_shared_fold_sync({}))
    tr = Trainer(cfg, dc, tc, device="cpu")
    out = tr.run(w, now_fn=lambda: 0)
    assert not out["crashed"] and out["step"] == tc.steps
    assert all(np.isfinite([m["loss"] for m in out["metrics"]]))
    assert tr.params["embed"]["w"].dtype == torch.bfloat16


def test_crash_restart_resumes_from_checkpoint_as_jax(tmp_path):
    cfg, dc, tc = _tiny(tmp_path, steps=10)
    shared = {}
    sync = el.make_shared_fold_sync(shared)
    q = el.make_queue(num_shards=6, num_workers=2)
    w1 = el.Worker(1, q, sync, stale_timeout=50)
    t1 = Trainer(cfg, dc, tc, device="cpu")
    out1 = t1.run(w1, now_fn=lambda: 0, fail_after_steps=5)
    assert out1["crashed"] and out1["step"] == 5
    t1.ckpt.wait()

    w2 = el.Worker(2, shared["state"], sync, stale_timeout=50)
    t2 = Trainer(cfg, dc, tc, device="cpu")
    assert t2.maybe_restore()
    assert t2.step == 4                      # JAX's test: the last save
    restored = tree.leaves(t2.params)
    assert all(p.requires_grad for p in restored)
    out2 = t2.run(w2, now_fn=lambda: 1000)
    assert not out2["crashed"] and out2["step"] == tc.steps


def test_trainer_losses_follow_jax_from_its_state(tmp_path):
    jcfg, jdc, jtc = _tiny(tmp_path / "jax", pkg="jax")
    tcfg, tdc, ttc = _tiny(tmp_path / "port")
    jt = jtrainer.Trainer(jcfg, jdc, jtc)
    tt = Trainer(tcfg, tdc, ttc, device="cpu")
    tt.params = convert.params_from_jax(jax.tree.map(np.asarray, jt.params),
                                        tcfg, device="cpu")
    tt.opt_state = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jt.opt_state), tcfg, device="cpu")
    outs = []
    for pkg, tr in ((jel, jt), (el, tt)):
        q = pkg.make_queue(num_shards=8, num_workers=1)
        w = pkg.Worker(1, q, pkg.make_shared_fold_sync({}))
        outs.append(tr.run(w, now_fn=lambda: 0))
    want, got = ([m["loss"] for m in o["metrics"]] for o in outs)
    assert len(got) == len(want) == ttc.steps
    err = np.abs(np.asarray(got) / np.asarray(want) - 1)
    print(f"per-step loss |port / jax - 1| max {err.max():.3g}")
    assert err.max() <= 1e-3, err


def test_trainer_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the trainer runs there")
    cfg, dc, tc = _tiny(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, dc, tc)
