"""Atomic, async checkpointing with restore validation, in the JAX
reference's on-disk layout.

Layout:  <dir>/step_<N>/
           meta.json            tree structure + shapes/dtypes + step
           arr_<i>.npy          one file per leaf
         <dir>/LATEST           text pointer, written last (atomic commit)

Writes go to a tmp directory first and are renamed into place, so a crash
mid-write can never corrupt the latest checkpoint; the LATEST pointer is
flipped only after the step directory is complete.  ``AsyncCheckpointer``
copies the tree to the host on the caller's thread (a consistent snapshot:
the optimizer updates parameters in place) and writes the files on a
worker thread.  GC keeps the newest ``keep`` steps.

Leaves are tensors (any device), in ``core.tree.leaves`` order.  bfloat16 is stored as its 16-bit pattern (``uint16``), as the
reference stores it, and restored through an int16 view into
``torch.bfloat16``: no ``ml_dtypes`` is needed either way.  A restored
leaf lands on the device of its ``tree_like`` counterpart.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_mod

Params = Any


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as the array that is written: C order, bf16 as uint16."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save(directory: str | Path, step: int, tree: Params, *, keep: int = 3
         ) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    # treedef: the containers with "*" leaves, for a reader (restore checks
    # the leaf count and shapes).
    meta = {"step": int(step),
            "treedef": str(tree_mod.map(lambda _: "*", tree)), "leaves": []}
    for i, leaf in enumerate(tree_mod.leaves(tree)):
        np.save(tmp / f"arr_{i}.npy", _host(leaf))
        meta["leaves"].append({
            "shape": list(leaf.shape),
            "dtype": str(leaf.dtype).removeprefix("torch.")})
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                                  # atomic commit
    (directory / "LATEST.tmp").write_text(final.name)
    (directory / "LATEST.tmp").rename(directory / "LATEST")
    _gc(directory, keep)
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    ptr = directory / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (directory / name / "meta.json").exists():
        return None
    return int(name.split("_")[1])


def restore(directory: str | Path, tree_like: Params,
            step: Optional[int] = None) -> tuple[Params, int]:
    """Restore into the structure of ``tree_like`` (validates the leaf
    count and shapes); each leaf goes to its counterpart's device."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    leaves_like = tree_mod.leaves(tree_like)
    if len(leaves_like) != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint has {len(meta['leaves'])} leaves, expected "
            f"{len(leaves_like)} — tree structure changed")
    leaves = []
    for i, (like, info) in enumerate(zip(leaves_like, meta["leaves"])):
        arr = np.load(d / f"arr_{i}.npy")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        if info["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        leaves.append(t.to(like.device))
    return tree_mod.unflatten(tree_like, leaves), int(meta["step"])


def _gc(directory: Path, keep: int) -> None:
    steps = sorted(p for p in directory.glob("step_*") if p.is_dir())
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


class AsyncCheckpointer:
    """Overlap checkpoint file IO with training compute."""

    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Params) -> None:
        self.wait()
        # Device -> host copies happen here, on the caller's thread (a
        # consistent snapshot; CPU leaves are copied too, since the
        # optimizer writes them in place); file IO on the worker thread.
        host_tree = tree_mod.map(
            lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save(self.directory, step, host_tree, keep=self.keep)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
