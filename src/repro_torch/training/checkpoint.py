"""Checkpointing: atomic, manifest-driven, in the JAX package's on-disk
format.

Layout (one directory per step), as the reference's
``training/checkpoint.py`` writes it:
  <dir>/step_000123/
      manifest.json     — step, tree structure, leaf shapes/dtypes, status
      leaves.npz        — flat leaf arrays keyed ``leaf_<i>``

Leaves are numbered in the reference's flatten order (``tree``), so a tree
of the reference's structure written by either package restores in the
other; ``models.convert`` gives the port's parameters that structure, and
``fault.adam_to_jax`` its ``AdamState`` (``ResilientLoop(model_cfg=...)``
writes them so).  A bf16 leaf is written as f32, which holds it exactly
and which the reference's ``restore`` casts back to bf16: the port has no
numpy bf16 type.  A bf16
leaf the reference wrote (``np.savez`` stores its 2-byte records as raw
``V2``; the manifest says ``bfloat16``) is read from its bits.

Guarantees (the reference's):
  * atomicity — writes go to ``step_X.tmp-<pid>`` then ``os.replace`` to the
    final name; a crash mid-write never corrupts the latest checkpoint;
  * auto-resume — ``latest_step``/``restore`` pick the newest COMPLETE step;
  * bounded retention — ``keep`` newest checkpoints survive;
  * elastic reshape — leaves are stored unsharded, so a checkpoint restores
    under any mesh: ``fault.ResilientLoop`` under a mesh gathers the
    ZeRO-1 moment slices before a save and re-slices them after a restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import to_numpy
from repro_torch.training.tree import structure, tree_leaves, tree_map, tree_unflatten


def _bf16_bits_to_f32(a: np.ndarray) -> np.ndarray:
    return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def save(
    ckpt_dir: str | Path,
    step: int,
    tree: Any,
    *,
    keep: int = 3,
    extra_meta: Optional[Dict] = None,
) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves = [to_numpy(l) for l in tree_leaves(tree)]
    np.savez(tmp / "leaves.npz", **{f"leaf_{i}": l for i, l in enumerate(leaves)})
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": structure(tree),
        "shapes": [list(l.shape) for l in leaves],
        "dtypes": [str(l.dtype) for l in leaves],
        "written_at": time.time(),
        "complete": True,
        **(extra_meta or {}),
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish

    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*") if not p.name.endswith("tmp"))
    steps = [p for p in steps if (p / "manifest.json").exists()]
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
    for p in ckpt_dir.glob("*.tmp-*"):
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    best = None
    for p in sorted(ckpt_dir.glob("step_*")):
        mf = p / "manifest.json"
        if not mf.exists():
            continue  # incomplete (crashed mid-write before publish)
        try:
            m = json.loads(mf.read_text())
        except json.JSONDecodeError:
            continue
        if m.get("complete"):
            best = m["step"]
    return best


def _like_leaf(arr: np.ndarray, tgt: Any) -> Any:
    """``arr`` in the target leaf's dtype: a tensor on its device, or numpy."""
    if isinstance(tgt, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=tgt.device,
                                                                 dtype=tgt.dtype)
    return arr.astype(np.asarray(tgt).dtype)


def restore(ckpt_dir: str | Path, like: Any, step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (shape-checked; raises
    ``ValueError`` on a mismatch).  Returns (tree, step): each leaf in its
    ``like`` leaf's dtype, a tensor on that leaf's device where ``like``
    holds a tensor, host numpy where it holds an array."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    data = np.load(d / "leaves.npz")

    leaves_like = tree_leaves(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target {len(leaves_like)}")
    out: List[Any] = []
    for i, tgt in enumerate(leaves_like):
        arr = data[f"leaf_{i}"]
        if arr.dtype.kind == "V" and manifest["dtypes"][i] == "bfloat16":
            arr = _bf16_bits_to_f32(arr)
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"leaf {i}: checkpoint {arr.shape} vs target {tuple(tgt.shape)}")
        out.append(_like_leaf(arr, tgt))
    return tree_unflatten(like, out), step


class AsyncCheckpointer:
    """Fire-and-forget background saves (the device->host copy happens on
    the caller thread; serialization runs on a worker so the train loop
    keeps stepping)."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, **kw) -> None:
        host_tree = tree_map(to_numpy, tree)  # sync copy
        self.wait()
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_tree),
            kwargs={"keep": self.keep, **kw}, daemon=True,
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
