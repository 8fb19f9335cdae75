"""Training launcher: elastic, fault-tolerant, checkpointed.

Runs any registered arch (reduced config by default: ``--full-config``
takes the published widths) on the card, or on the CPU with ``--device
cpu``.  Workers take turns in one process over the CRDT work queue, which
replaces a central data scheduler; ``--fail-worker1-at`` crashes worker 1
so that the next one restores the last checkpoint and reclaims its shard.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 100 --workers 2 [--fail-worker1-at 30] [--full-config] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import repro_torch.configs as configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.elastic import Worker, make_queue, \
    make_shared_fold_sync
from repro_torch.training.optimizer import AdamW
from repro_torch.training.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=sorted(configs.ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-worker1-at", type=int, default=None,
                    help="inject a worker-1 crash after N steps")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full arch config")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = configs.get(args.arch)
    if not args.full_config:
        cfg = configs.reduced(cfg, d_model=128, vocab=1024)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          batch_size=args.batch)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    tcfg = TrainerConfig(steps=args.steps, checkpoint_every=args.ckpt_every,
                         checkpoint_dir=ckpt)
    opt = AdamW(lr_peak=args.lr, warmup=max(args.steps // 10, 1),
                total_steps=args.steps)

    shared: dict = {}
    sync = make_shared_fold_sync(shared)
    queue = make_queue(num_shards=max(args.steps // 4 + 2, 8),
                       num_workers=args.workers)

    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"steps={args.steps} workers={args.workers} ckpt={ckpt}")

    state = queue
    for w_id in range(1, args.workers + 1):
        worker = Worker(w_id, state, sync)
        trainer = Trainer(cfg, data_cfg, tcfg, opt=opt, device=args.device)
        trainer.maybe_restore()
        fail = args.fail_worker1_at if w_id == 1 else None
        out = trainer.run(worker, now_fn=lambda w=w_id: w * 1000,
                          fail_after_steps=fail)
        last = out["metrics"][-1] if out["metrics"] else {}
        print(f"worker{w_id}: crashed={out['crashed']} step={out['step']} "
              f"loss={last.get('loss', float('nan')):.4f} "
              f"grad_norm={last.get('grad_norm', float('nan')):.3f}")
        state = shared["state"]
        if not out["crashed"] and out["step"] >= args.steps:
            break
    print("done")


if __name__ == "__main__":
    main()
