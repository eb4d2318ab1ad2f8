"""Checkpointing: nested-dict trees <-> npz files — the port of
`repro/checkpoint/io.py`, with the same file layout.

Paths are flattened with '/' separators, a None leaf is stored as an empty
array under `<path>~none`, stepped checkpoints are `ckpt_<step:08d>.npz`
written atomically. Tensors are taken to host numpy before saving, and
loading gives numpy arrays, so a checkpoint written by either package
loads in the other.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif tree is None:
        out[prefix[:-1] + "~none"] = np.zeros((0,))
    else:
        out[prefix[:-1]] = (tree.detach().cpu().numpy()
                            if isinstance(tree, torch.Tensor)
                            else np.asarray(tree))
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        if path.endswith("~none"):
            path, v = path[: -len("~none")].rstrip("/"), None
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path: str, tree: Any, *, step: Optional[int] = None,
                    keep_last: Optional[int] = None) -> str:
    """Write `tree` to npz. With `step`, writes ckpt_<step>.npz under
    `path` ATOMICALLY (tmp + rename, so a kill mid-write never leaves a
    truncated checkpoint for resume to trip on) and, with `keep_last`,
    prunes all but the newest `keep_last` step files."""
    if keep_last is not None:
        if step is None:
            raise ValueError("keep_last only applies to stepped "
                             "checkpoints (pass step=)")
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last} "
                             "(the checkpoint being written always stays)")
    if step is not None:
        ckpt_dir, path = path, os.path.join(path, f"ckpt_{step:08d}.npz")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(tree))
    os.replace(tmp, path)
    if step is not None and keep_last is not None:
        for old in all_checkpoints(ckpt_dir)[:-keep_last]:
            os.remove(old)
    return path


def load_checkpoint(path: str) -> Any:
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def all_checkpoints(ckpt_dir: str) -> list:
    """Step-ordered list of checkpoint paths in `ckpt_dir`."""
    if not os.path.isdir(ckpt_dir):
        return []
    pat = re.compile(r"ckpt_(\d+)\.npz$")
    found = [(int(m.group(1)), os.path.join(ckpt_dir, f))
             for f in os.listdir(ckpt_dir) if (m := pat.match(f))]
    return [p for _, p in sorted(found)]


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = all_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def load_latest(ckpt_dir: str) -> Optional[Any]:
    """Load the newest INTACT checkpoint in `ckpt_dir`, or None when the
    directory holds none. The resumable-training entry point: engines call
    this on restart.

    Writes are atomic (tmp + rename), so a torn tail file should never
    exist — but a copied-in or disk-damaged npz can still fail to parse,
    and dying on it would leave the run unresumable even though older
    intact checkpoints sit right next to it. A corrupt tail is therefore
    skipped with a warning and the next-newest checkpoint loads instead
    (the engine then replays the lost rounds deterministically)."""
    import sys
    import zipfile
    for path in reversed(all_checkpoints(ckpt_dir)):
        try:
            return load_checkpoint(path)
        except (zipfile.BadZipFile, ValueError, EOFError, OSError) as e:
            print(f"warning: skipping corrupt checkpoint {path}: {e}",
                  file=sys.stderr)
    return None
