"""Fault-tolerant training loop.

Composes: CRDT elastic work queue (shard claims) + deterministic data
pipeline + the train step + async checkpointing + crash/restart recovery.
``run`` survives injected worker failures: a failed worker's claimed shard
times out, is reclaimed by a survivor, and training resumes from the last
checkpoint with bit-identical data.

The model and optimizer live on ``device`` (the card unless the caller
passes ``device="cpu"``); the work queue lives on the host.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch import resolve_device
from repro_torch.core import tree
from repro_torch.data.pipeline import DataConfig, shard_batches
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import checkpoint as ckpt_mod
from repro_torch.runtime.elastic import Worker
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import to_device, make_train_step


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = field(default_factory=_default_ckpt_dir)
    keep: int = 2
    shard_timeout: int = 120


class Trainer:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, opt: Optional[AdamW] = None,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt = opt or AdamW(warmup=10, total_steps=tcfg.steps)
        self.params = lm.init(cfg, seed=seed, device=self.device)
        for leaf in tree.leaves(self.params):
            leaf.requires_grad_()
        self.opt_state = self.opt.init(self.params)
        self.step = 0
        self._train_step = make_train_step(cfg, self.opt, remat=False)
        self.ckpt = ckpt_mod.AsyncCheckpointer(tcfg.checkpoint_dir,
                                               keep=tcfg.keep)

    # -- checkpoint/restart -------------------------------------------------

    def save(self) -> None:
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt": self.opt_state})

    def maybe_restore(self) -> bool:
        latest = ckpt_mod.latest_step(self.tcfg.checkpoint_dir)
        if latest is None:
            return False
        restored, step = ckpt_mod.restore(
            self.tcfg.checkpoint_dir,
            {"params": self.params, "opt": self.opt_state})
        self.params, self.opt_state = restored["params"], restored["opt"]
        for leaf in tree.leaves(self.params):
            leaf.requires_grad_()
        self.step = step
        return True

    # -- elastic training loop ----------------------------------------------

    def run(self, worker: Worker, *, now_fn: Callable[[], int] = None,
            fail_after_steps: Optional[int] = None) -> dict:
        """Train until the queue is drained or tcfg.steps is reached.

        ``fail_after_steps`` injects a crash (for fault-tolerance tests):
        the worker simply stops, leaving its claim to go stale.
        """
        now_fn = now_fn or (lambda: int(time.time()))
        metrics_hist = []
        steps_done = 0
        while self.step < self.tcfg.steps and not worker.done():
            worker.heartbeat(now_fn())
            worker.reclaim_stale(now_fn())
            shard = worker.try_claim_shard(now_fn())
            if shard is None:
                if worker.done():
                    break
                continue
            for batch in shard_batches(self.data_cfg, shard):
                batch = to_device(batch, self.device)
                self.params, self.opt_state, m = self._train_step(
                    self.params, self.opt_state, batch)
                self.step += 1
                steps_done += 1
                metrics_hist.append({k: float(v) for k, v in m.items()})
                if self.step % self.tcfg.checkpoint_every == 0:
                    self.save()
                if fail_after_steps is not None and steps_done >= fail_after_steps:
                    return {"crashed": True, "step": self.step,
                            "metrics": metrics_hist}
                if self.step >= self.tcfg.steps:
                    break
            worker.complete_shard(shard)
        self.save()
        self.ckpt.wait()
        return {"crashed": False, "step": self.step, "metrics": metrics_hist}
