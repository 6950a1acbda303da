"""Checkpoint save and restore with auto-resume.

Port of flash_vstream_tpu/train/checkpoint.py with `torch.save` in place of
orbax, in the same layout: `<output_dir>/checkpoint-<step>/` directories
holding {params, opt_state}, the newest `keep` kept. `export_safetensors`
raises: the port has no safetensors writer yet (ROADMAP A10).
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional, Tuple

import torch

_STATE = "state.pt"


def _ckpt_dirs(output_dir: str):
    if not os.path.isdir(output_dir):
        return []
    out = []
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and os.path.exists(os.path.join(output_dir, name, _STATE)):
            out.append((int(m.group(1)), os.path.join(output_dir, name)))
    return sorted(out)


def latest_checkpoint(output_dir: str) -> Optional[Tuple[int, str]]:
    dirs = _ckpt_dirs(output_dir)
    return dirs[-1] if dirs else None


def save_checkpoint(output_dir: str, step: int, params: Any,
                    opt_state: Any = None, keep: int = 3) -> str:
    """Write checkpoint-<step>/ (atomically: a reader never sees half a
    file) and prune all but the newest `keep`."""
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    os.makedirs(path, exist_ok=True)
    payload = {"params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    tmp = os.path.join(path, _STATE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _STATE))
    for _, old in _ckpt_dirs(output_dir)[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return path


def restore_checkpoint(output_dir: str, map_location=None
                       ) -> Optional[Tuple[int, Any]]:
    """(step, payload) of the latest checkpoint, or None; tensors load onto
    `map_location`."""
    latest = latest_checkpoint(output_dir)
    if latest is None:
        return None
    step, path = latest
    payload = torch.load(os.path.join(path, _STATE), map_location=map_location,
                         weights_only=True)
    return step, payload


def export_safetensors(path: str, params: Any, prefix: str = ""):
    raise NotImplementedError(
        "merged-weight export needs a safetensors writer, not ported yet: "
        "ROADMAP A10")
