"""Checkpoint save / load with ``torch.save``.

Port of ``nerfdet_tpu/utils/checkpoint.py``: epoch checkpoints
``ckpt_dir/ckpt_{epoch}.pth`` holding a payload (the train CLI's: the
model's ``state_dict``, the optimizer's state, the step and the epoch)
and its meta (epoch and config path), the newest kept ``max_keep``, the
latest found by number. Files are read with ``weights_only=True``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch


def save_checkpoint(ckpt_dir: str, step: int, payload: Dict[str, Any],
                    meta: Optional[Dict] = None,
                    max_keep: int = -1) -> str:
    """Save ``payload`` (tensors, numbers, strings, lists and dicts of
    them) and ``meta`` at ``ckpt_dir/ckpt_{step}.pth``; with ``max_keep``
    > 0 delete all but the newest ``max_keep``. Returns the path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pth")
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(dict(payload, meta=dict(meta or {})), tmp)
    os.replace(tmp, path)  # a reader never sees a partial file
    if max_keep > 0:
        for _, old in sorted(_list_checkpoints(ckpt_dir))[:-max_keep]:
            os.remove(old)
    return path


def _list_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"ckpt_(\d+)\.pth", name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return out


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = sorted(_list_checkpoints(ckpt_dir))
    return ckpts[-1][1] if ckpts else None


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """Load a checkpoint file, or the latest one of a checkpoint dir."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = latest
    return torch.load(path, map_location=map_location, weights_only=True)


def load_meta(path: str) -> Dict:
    """The meta saved with a checkpoint ({} where there is none)."""
    return dict(load_checkpoint(path).get("meta", {}))
