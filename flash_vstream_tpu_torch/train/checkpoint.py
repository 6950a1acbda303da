"""Checkpoint save and restore with auto-resume.

Port of flash_vstream_tpu/train/checkpoint.py with `torch.save` in place of
orbax, in the same layout: `<output_dir>/checkpoint-<step>/` directories
holding {params, opt_state}, the newest `keep` kept. `export_safetensors`
writes a parameter tree as one `.safetensors` file through the port's own
writer (weights/safetensors_io.py), where JAX takes `safetensors.numpy`.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from ..weights.safetensors_io import save_file

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
    from ..weights.quantize import QuantWeight, QuantWeight4
    # a quantized base's leaves are NamedTuples of tensors
    with torch.serialization.safe_globals([QuantWeight, QuantWeight4]):
        payload = torch.load(os.path.join(path, _STATE),
                             map_location=map_location, weights_only=True)
    return step, payload


def flatten_tree(params: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A parameter tree as {name: tensor}: dict keys, NamedTuple fields (a
    quantized leaf's `.q`/`.q4` and `.scale`) and list indices joined with
    '.', each name prefixed by `prefix`, as JAX's export visitor spells
    them (checkpoint.py:66-87)."""
    flat: Dict[str, torch.Tensor] = {}

    def visit(p, x):
        if isinstance(x, dict):
            for k, v in x.items():
                visit(f"{p}.{k}" if p else k, v)
        elif hasattr(x, "_fields"):      # NamedTuple, before tuple
            for k in x._fields:
                visit(f"{p}.{k}", getattr(x, k))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                visit(f"{p}.{i}", v)
        else:
            flat[prefix + p] = torch.as_tensor(x).detach()

    visit("", params)
    return flat


def export_safetensors(path: str, params: Any, prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """Write `flatten_tree(params, prefix)` to one `.safetensors` file at
    `path`; returns the flat {name: tensor}."""
    flat = flatten_tree(params, prefix)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_file(flat, path)
    return flat
