"""Disaggregated streaming serve: ingest on its own device, decode on the
rest.

Port of flash_vstream_tpu/parallel/serve.py:33-72. The reference keeps
ingest alive while answering by giving the frame memory manager a second
GPU (Flash-VStream-Qwen/cli_server_2gpu.py:197-239) and handing tensors
across processes through CPU shared memory. Here one process drives both
sides, as in JAX:

- the ingest device holds the whole vision tower and the Flash memory
  state; every clip's encode and consolidation runs there;
- the decode devices hold the decoder split tensor-parallel
  (parallel/inference.py) and the patch merger, which runs at answer time
  on the first of them;
- the published memory snapshot moves ingest -> decode at answer time
  (`QwenStreamSession._snapshot_to_decode`).

A device may be listed more than once (`devices=[cuda:0] * 3`): the split
then runs on one card, which exercises the sharded code and the handover
without a second card.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

from ..models.qwen2_vit import PatchMerger, QwenVisionTransformer
from .inference import shard_params_for_inference
from .sharding import (Mesh, _device, create_mesh, map_with_path,
                       visible_devices)


class ServePlacement(NamedTuple):
    ingest_device: Any      # torch.device of the vision tower + memory state
    decode_mesh: Mesh       # (1, tp) mesh of the decoder + merger


def make_serve_placement(n_ingest: int = 1, n_decode: Optional[int] = None,
                         devices: Optional[Sequence] = None
                         ) -> ServePlacement:
    """Split `devices` (default: the visible cards) into [ingest | decode]
    contiguous groups. n_ingest > 1 reserves spare ingest devices; the
    session pins to the first; n_decode None takes every device after the
    ingest group."""
    devices = list(devices) if devices is not None else visible_devices()
    if n_ingest < 1:
        raise ValueError(f"n_ingest must be >= 1, got {n_ingest}")
    if len(devices) < n_ingest + 1:
        raise ValueError(
            f"disaggregated serve needs >= {n_ingest + 1} devices, have "
            f"{len(devices)} (single-chip: use --preempt instead)")
    if n_decode is None:
        n_decode = len(devices) - n_ingest
    if n_decode < 1 or n_ingest + n_decode > len(devices):
        raise ValueError(f"{n_ingest} ingest + {n_decode} decode devices of "
                         f"{len(devices)}")
    decode = devices[n_ingest:n_ingest + n_decode]
    return ServePlacement(
        ingest_device=_device(devices[0]),
        decode_mesh=create_mesh(dp=1, tp=len(decode), devices=decode))


def _tree_to(tree, device):
    """A parameter tree's tensors on `device` (`.to`: the same tensor where
    it already is)."""
    return map_with_path(lambda path, x: x.to(device), tree)


def place_qwen_serve_params(model, placement: ServePlacement):
    """Split a `VStreamQwen` across the placement: returns (ingest, decode),
    {"vit": the whole vision tower on the ingest device} and {"vit":
    {"merger": the patch merger on the first decode device}, "llm": the
    tensor-parallel decoder}. The model itself is not moved: each side
    holds new modules over its tensors (the same tensors on a device they
    are already on)."""
    vit_cfg = model.cfg.vit
    vit = QwenVisionTransformer(
        vit_cfg, _tree_to(model.vit.tree(), placement.ingest_device))
    first = placement.decode_mesh.devices[0, 0]
    merger = PatchMerger(_tree_to(model.vit.merger.tree(), first))
    llm, _ = shard_params_for_inference(model.llm,
                                        mesh=placement.decode_mesh)
    return {"vit": vit}, {"vit": {"merger": merger}, "llm": llm}
