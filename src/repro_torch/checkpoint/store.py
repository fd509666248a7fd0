"""Step-atomic checkpoints of a tree of tensors on one device — the port
of `repro/checkpoint/store.py`, with its on-disk layout:

  * writes go to ``step_N.tmp/`` and are renamed to ``step_N/`` only
    after an fsync, so a failure mid-save never corrupts the latest
    restorable step;
  * one ``.npy`` per leaf, named by the leaf's path with "/" as "__";
    bf16 leaves are stored as their raw bits (uint16), as JAX's
    `_BITCAST` does, since numpy has no bf16;
  * an ``index.json`` with each leaf's shape, dtype name and file, and
    the caller's ``aux`` (the data pipeline's cursor, the step counter);
  * `CheckpointManager.save` copies the tree to the host, then writes it
    synchronously or in one background thread (at most one in flight),
    and keeps the newest `keep` steps.

A tree is nested dicts of tensors; the port keys its model and optimizer
leaves by state-dict name ({"params": {"blocks.0.attn.wq": ...}, "opt":
{"mu": {...}, "nu": {...}, "step": ...}}). Restoring across the two
packages (JAX's layer-stacked leaves) is later work.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def _to_savable(t: torch.Tensor):
    # A copy even on the CPU, where .cpu() would alias the live storage
    # that the next step's in-place update overwrites under an async save.
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:       # numpy has no bf16: the raw bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree, prefix=()) -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


def _unflatten_like(like, flat, prefix=()):
    out = {}
    for k, v in like.items():
        path = prefix + (str(k),)
        out[k] = _unflatten_like(v, flat, path) if isinstance(v, dict) \
            else flat["/".join(path)]
    return out


def _host(tree):
    return {k: (_host(v) if isinstance(v, dict) else _to_savable(
        torch.as_tensor(v))) for k, v in tree.items()}


def save_tree(path: os.PathLike, tree, *, aux: Optional[Dict] = None):
    """Atomic save of a nested dict of tensors (or of (array, dtype name)
    pairs already on the host)."""
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    index = {"leaves": {}, "aux": aux or {}}
    for key, leaf in _flatten(tree).items():
        data, dtn = leaf if isinstance(leaf, tuple) \
            else _to_savable(torch.as_tensor(leaf))
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, data)
        index["leaves"][key] = {"shape": list(data.shape), "dtype": dtn,
                                "sharded": False, "file": fname}
    (tmp / "index.json").write_text(json.dumps(index))
    fd = os.open(tmp, os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    if path.exists():
        shutil.rmtree(path)
    os.rename(tmp, path)


def restore_tree(path: os.PathLike, like):
    """Restore into the structure of `like` (a nested dict of tensors):
    each leaf in its saved dtype, on the device of `like`'s leaf.
    Returns (tree, aux)."""
    path = Path(path)
    index = json.loads((path / "index.json").read_text())
    flat_like = _flatten(like)
    missing = set(flat_like) - set(index["leaves"])
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
    flat = {}
    for key, ref in flat_like.items():
        meta = index["leaves"][key]
        t = _from_saved(np.load(path / meta["file"]), meta["dtype"])
        flat[key] = t.to(ref.device) if torch.is_tensor(ref) else t
    return _unflatten_like(like, flat), index.get("aux", {})


class CheckpointManager:
    """Step-numbered checkpoints with retention, async save and resume."""

    def __init__(self, root: os.PathLike, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def _dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def steps(self):
        return sorted(int(p.name.split("_")[1]) for p in
                      self.root.glob("step_*") if p.is_dir()
                      and not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, aux: Optional[Dict] = None,
             async_: bool = False):
        self.wait()                      # at most one save in flight
        host_tree = _host(tree)          # device -> host, before returning

        def work():
            save_tree(self._dir(step), host_tree,
                      aux={**(aux or {}), "step": step})
            self._gc()
        if async_:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, like, step: Optional[int] = None):
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return restore_tree(self._dir(step), like)

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
