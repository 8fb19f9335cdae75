"""The port's launchers and its elastic-training example, run as a user
runs them (a subprocess, ``--device cpu``), as tests/test_launchers.py runs
JAX's: the training launcher's crash and recovery lines, the serving
launcher's JSON, and the example's finish."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parent.parent / "src")


def _run(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_launcher_elastic_crash_recovery(tmp_path):
    out = _run("repro_torch.launch.train", "--arch", "olmo-1b", "--steps",
               "8", "--workers", "2", "--fail-worker1-at", "3", "--seq-len",
               "32", "--batch", "2", "--ckpt-every", "2", "--ckpt-dir",
               str(tmp_path), "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "worker1: crashed=True step=3" in out.stdout
    assert "worker2: crashed=False step=8" in out.stdout
    assert out.stdout.rstrip().endswith("done")
    assert (tmp_path / "LATEST").read_text() == "step_00000008"


def test_train_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher runs there")
    out = _run("repro_torch.launch.train", "--steps", "1")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_serve_launcher_json():
    out = _run("repro_torch.launch.serve", "--arch", "olmo-1b", "--task",
               "tic_tac_toe", "--mode", "parallel", "--agents", "2",
               "--json", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout[out.stdout.index("{"):])
    assert res["parallel"]["converged"] is True
    assert res["parallel"]["tokens"] > 0


def test_elastic_training_example_finishes():
    out = _run("repro_torch.examples.elastic_training", "30", "--device",
               "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "worker1 CRASHED at step 10" in out.stdout
    assert "worker2 restored=True at step 10" in out.stdout
    assert "worker2 reclaimed 1 stale shard(s)" in out.stdout
    assert "worker2 finished at step 30" in out.stdout
    assert "OK: training survived worker failure" in out.stdout
