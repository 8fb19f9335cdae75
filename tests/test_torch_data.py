"""The port's copy of the synthetic data pipeline against the JAX
package's: ``shard_batches`` bitwise over several (seed, shard) pairs and
configurations (the elastic queue rests on shard -> batches being a pure
function of them), the packing invariants, and ``Prefetcher`` order and
count."""
from __future__ import annotations

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe

CFGS = [dict(vocab_size=101, seq_len=32, batch_size=4, shard_size_batches=3),
        dict(vocab_size=50304, seq_len=128, batch_size=2,
             shard_size_batches=2),
        dict(vocab_size=97, seq_len=12, batch_size=2, shard_size_batches=3,
             mean_doc_len=4)]


@pytest.mark.parametrize("cfg", range(len(CFGS)))
@pytest.mark.parametrize("seed,shard", [(0, 0), (0, 5), (3, 1), (1234, 49)])
def test_shard_batches_bitwise_equal_jax(cfg, seed, shard):
    want = jpipe.shard_batches(jpipe.DataConfig(**CFGS[cfg], seed=seed),
                               shard)
    got = tpipe.shard_batches(tpipe.DataConfig(**CFGS[cfg], seed=seed), shard)
    assert len(got) == len(want) == CFGS[cfg]["shard_size_batches"]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["loss_mask", "targets", "tokens"]
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_shards_differ_and_pack_as_jax_does():
    cfg = tpipe.DataConfig(**CFGS[0])
    a = tpipe.shard_batches(cfg, 0)[0]["tokens"]
    b = tpipe.shard_batches(cfg, 1)[0]["tokens"]
    assert not np.array_equal(a, b)
    for batch in tpipe.shard_batches(cfg, 3):
        assert batch["tokens"].shape == batch["targets"].shape == (4, 32)
        assert (batch["tokens"] >= 0).all()
        assert (batch["tokens"] < cfg.vocab_size).all()
        assert batch["loss_mask"].max() <= 1.0
        assert (batch["tokens"][:, 0] == 1).all()
        np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                      batch["targets"][:, :-1])


def test_prefetcher_preserves_order_and_count():
    cfg = tpipe.DataConfig(**CFGS[0])
    want = list(jpipe.shard_iterator(jpipe.DataConfig(**CFGS[0]),
                                     iter(range(3))))
    direct = list(tpipe.shard_iterator(cfg, iter(range(3))))
    fetched = list(tpipe.Prefetcher(tpipe.shard_iterator(cfg,
                                                         iter(range(3))),
                                    depth=1))
    assert len(direct) == len(fetched) == len(want) == 9
    for x, y, w in zip(direct, fetched, want):
        for k in w:
            np.testing.assert_array_equal(x[k], w[k])
            np.testing.assert_array_equal(y[k], w[k])
