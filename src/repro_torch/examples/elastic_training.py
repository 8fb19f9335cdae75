"""Elastic fault-tolerant training driven by the CRDT work queue.

Trains a reduced OLMo-1B with two elastic workers; worker 1 is killed
mid-run, its claimed data shard goes stale, worker 2 restores the last
checkpoint, reclaims the shard and finishes — with bit-identical data.

    PYTHONPATH=src python -m repro_torch.examples.elastic_training [steps] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import repro_torch.configs as configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.elastic import Worker, make_queue, \
    make_shared_fold_sync
from repro_torch.training.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", type=int, nargs="?", default=60)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    steps = args.steps

    cfg = configs.reduced(configs.get("olmo-1b"), d_model=64, vocab=512)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                          batch_size=4, shard_size_batches=4)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    tcfg = TrainerConfig(steps=steps, checkpoint_every=10,
                         checkpoint_dir=ckpt_dir, shard_timeout=50)

    shared: dict = {}
    sync = make_shared_fold_sync(shared)
    queue = make_queue(num_shards=max(steps // 4 + 2, 8), num_workers=2)

    print(f"model={cfg.name}(reduced) steps={steps} ckpt={ckpt_dir}")

    # Worker 1 trains, then 'crashes' mid-shard.
    w1 = Worker(1, queue, sync, stale_timeout=50)
    t1 = Trainer(cfg, data_cfg, tcfg, device=args.device)
    out1 = t1.run(w1, now_fn=lambda: 0, fail_after_steps=steps // 3)
    print(f"worker1 CRASHED at step {out1['step']} "
          f"(loss {out1['metrics'][-1]['loss']:.3f})")
    t1.ckpt.wait()

    # Worker 2 joins, restores the checkpoint, reclaims the stale shard.
    w2 = Worker(2, shared["state"], sync, stale_timeout=50)
    t2 = Trainer(cfg, data_cfg, tcfg, device=args.device)
    restored = t2.maybe_restore()
    print(f"worker2 restored={restored} at step {t2.step}")
    reclaimed = w2.reclaim_stale(now=1000)
    print(f"worker2 reclaimed {reclaimed} stale shard(s)")
    out2 = t2.run(w2, now_fn=lambda: 1000)
    losses = [m["loss"] for m in out2["metrics"]]
    print(f"worker2 finished at step {out2['step']}; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if out2["step"] < steps:
        raise SystemExit(f"worker2 stopped at step {out2['step']} < {steps}")
    print("OK: training survived worker failure with zero lost shards")


if __name__ == "__main__":
    main()
