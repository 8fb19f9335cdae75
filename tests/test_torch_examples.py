"""The port's three examples (``repro_torch.examples.quickstart``,
``multi_agent_codegen`` and ``serve_demo``), run as a user runs them: a
subprocess with ``--device cpu`` and small arguments, as
``test_torch_launchers.py`` runs the launchers.  Each exits 0 and prints
what the JAX package's copy prints."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parent.parent / "src")


def _run(*args: str) -> subprocess.CompletedProcess:
    # One intra-op thread: the models are 64 wide.
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_quickstart():
    out = _run("repro_torch.examples.quickstart", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "posted: [1, 1, 1, 1]"
    assert lines[-1] == "digests equal: True"
    assert "converged document tokens:" in out.stdout


def test_serve_demo():
    arch = "recurrentgemma-2b"
    out = _run("repro_torch.examples.serve_demo", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith(f"arch={arch} (reduced:")
    assert "batch=4 prompt=8 steps=12" in out.stdout
    assert out.stdout.rstrip().endswith("per-row positions: [19 19 19 19]")


def test_multi_agent_codegen():
    out = _run("repro_torch.examples.multi_agent_codegen", "tic_tac_toe",
               "2", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("task=tic_tac_toe coupling=low todos=8")
    assert out.stdout.count("converged=True") == 2
    assert "evaluator: 1 conflict(s), 1 auto-fixed, 0 flagged" in out.stdout

