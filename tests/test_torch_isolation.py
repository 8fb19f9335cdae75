"""The port stands alone: no JAX, nothing of ``repro``, and no quiet CPU
fallback when no card is present."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in (ROOT / "src" / "repro_torch").rglob("*.py"))


def test_port_imports_neither_jax_nor_repro():
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",           # any `import jax` now fails
        f"sys.path.insert(0, {str(ROOT)!r})",
        "import importlib",
        f"for m in {MODULES!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "bad = sorted(m for m in sys.modules",
        "             if m == 'repro' or m.startswith('repro.'))",
        "assert not bad, bad",
        "print(len(sys.modules))",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "repro_torch.kernels.ops" in MODULES


def test_entry_points_without_a_device_raise_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    from repro_torch import configs, convert
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    cfg = configs.reduced(configs.get("olmo-1b"), d_model=32, vocab=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 16)
    params = lm.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params, batch=1, max_len=16)
    tree = {"embed": {"table": np.zeros((4, 2), np.float32)},
            "final_norm": {}, "groups": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax(tree, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.cache_from_jax({"groups": {}}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.to_tensor(np.zeros(2, np.float32))
    from repro_torch.agents import orchestrator
    from repro_torch.agents.tasks import TASKS
    with pytest.raises(RuntimeError, match="no CUDA device"):
        orchestrator.run_task(cfg, params, TASKS["tic_tac_toe"],
                              mode="sequential")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        orchestrator.make_sim_llm()


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs for real")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
