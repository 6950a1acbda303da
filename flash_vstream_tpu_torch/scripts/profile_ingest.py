"""Stage-by-stage timing of the streaming ingest path on the card.

Counterpart of scripts/profile_ingest.py. Each stage runs as a chained
loop of --iters calls, fresh inputs each call (a bank of 4 clips read at
i % 4) and the memory state carried from call to call, timed with
scripts/timing.py: by CUDA-graph replay between CUDA events (device time,
as the JAX script's scan-in-jit gives it) and eagerly between CUDA events
(the port's ingest runs eagerly, so the host's launch rate shows), best of
--trials (on the CPU, the host's clock alone). A stage that runs the
device preprocess or the Flash memory update cannot be captured (the
preprocess and the pool copy constants from the host each call,
preprocess/image.py `qwen_device_preprocess`, ops/pooling.py
`qwen_temporal_pool`; the update reads a count on
the host, models/flash_memory.py `n_cat_host`): it prints its eager time
alone and "graph n/a"; the ViT and the merger print both.

Stages (--stages, comma list, or all): pre (device preprocess), vit (the
dual-resolution ViT blocks over both streams, frame-batched; the temporal
pool, which copies its matrix from the host each call, runs once a clip
outside the loop, as probe_vit_variants.py encodes), mem (the Flash memory update
over a saturated memory: k-means and retrieval), merge (the patch merger
over a full memory), full (pre + vit + mem: the production ingest, whose
merger runs at answer time), and the compositions previt and vitmem.
`--int8-vit` quantizes the ViT blocks to int8 and turns on w8a8 for the
run. `--layers` cuts the ViT's depth for a run on the CPU (--device cpu,
a small --side), where every time is the host's.

Prints a line a stage (ms a clip by replay and eagerly, the ViT's TF/s)
and one JSON line (metric `torch_ingest_profile`) with the card's name and
power limit.

Usage: python -m flash_vstream_tpu_torch.scripts.profile_ingest
           [--clip 8] [--side 224] [--iters 20] [--stages all] [--int8-vit]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.config import QWEN2_VL_VIT, FlashMemoryConfig
from ..core.device import resolve_device
from .timing import card_line, eager_seconds, graph_seconds

N_BANK = 4                 # clips of fresh input, read at i % N_BANK
STAGES = ("pre", "vit", "mem", "merge", "full", "previt", "vitmem")
# the preprocess copies host constants, the memory update syncs the host
GRAPH_NA = ("pre", "previt", "mem", "full", "vitmem")


@dataclasses.dataclass
class Ingest:
    """The ingest's pieces at one geometry: the ViT params and config, the
    memory config, the grid (t_clip, gh, gw), the frame and patch banks
    and the device."""
    vp: dict
    vit: object
    fm: FlashMemoryConfig
    t: int
    gh: int
    gw: int
    frames: torch.Tensor
    patches: torch.Tensor
    device: torch.device

    @property
    def p_full(self) -> int:
        return self.gh * self.gw

    @property
    def p_small(self) -> int:
        return (self.gh // 2) * (self.gw // 2)

    def vit_flops(self) -> float:
        """The JAX script's ViT FLOP count of one clip, both streams."""
        v = self.vit
        St = self.t * (self.p_full + self.p_small)
        D = v.hidden_size
        per_layer = (4 * 2 * St * D * D + 2 * 2 * St * D * v.intermediate_size
                     + 2 * 2 * self.t * v.num_heads * v.head_dim
                     * (self.p_full ** 2 + self.p_small ** 2))
        return v.num_layers * per_layer

    def state(self, saturated: bool = False):
        """A fresh memory state (bank 1,024); `saturated` fills every CSM
        slot so the update runs the whole clustering."""
        from ..models.flash_memory import init_flash_state
        st = init_flash_state(self.fm, self.p_full, self.p_small,
                              self.vit.hidden_size, bank_size=1024,
                              device=self.device)
        if saturated:
            g = torch.Generator(device=self.device).manual_seed(1)
            st = st._replace(
                tem_x=torch.randn(st.tem_x.shape, generator=g,
                                  device=self.device, dtype=st.tem_x.dtype),
                tem_valid=torch.ones_like(st.tem_valid),
                tem_weights=torch.ones_like(st.tem_weights),
                n_frames=600)
        return st

    def preprocess(self, f):
        from ..preprocess.image import qwen_device_preprocess
        return qwen_device_preprocess(f)

    def streams(self, p):
        """Patches [t*gh*gw, pd] -> both streams' patches (the temporal
        pool's small stream after the full one)."""
        from ..ops.pooling import qwen_temporal_pool
        small, _ = qwen_temporal_pool(p.float(), (self.t, self.gh, self.gw))
        return torch.cat([p, small.to(p.dtype)])

    def blocks(self, allp):
        """Both streams' patches -> the ViT's hidden states."""
        from ..models.qwen2_vit import qwen_vit_blocks_frames
        return qwen_vit_blocks_frames(
            self.vp, self.vit, allp, t_full=self.t,
            hw_full=(self.gh, self.gw), t_small=self.t,
            hw_small=(self.gh // 2, self.gw // 2))

    def encode(self, p):
        """Patches [t*gh*gw, pd] -> the ViT's hidden states of both
        streams (pool, then blocks)."""
        return self.blocks(self.streams(p))

    def update(self, state, hidden, draws):
        """The memory update of a clip's hidden states: (state, snapshot)."""
        from ..models.flash_memory import flash_stream_update
        S, D = self.t * self.p_full, self.vit.hidden_size
        x = hidden[:S].reshape(self.t, self.p_full, D)
        sx = hidden[S:].reshape(self.t, self.p_small, D)
        return flash_stream_update(self.fm, state, x, sx, self.t, draws)

    def merge(self, vis):
        from ..models.qwen2_vit import patch_merger
        return patch_merger(self.vp, vis)


def setup(side: int, clip: int, layers: Optional[int], int8: bool,
          device: torch.device) -> Ingest:
    """The full-width Qwen2-VL ViT (bf16, seed 0; --layers cuts it) and the
    default Flash memory config at `side` px clips of `clip` frames."""
    from ..models.qwen2_vit import init_qwen_vit_params
    from ..preprocess.image import smart_resize
    from ..weights.quantize import quantize_params
    vit = QWEN2_VL_VIT
    if layers is not None:
        vit = dataclasses.replace(vit, num_layers=layers)
    vp = init_qwen_vit_params(vit, torch.Generator(device=device).manual_seed(
        0), device, dtype=torch.bfloat16)
    if int8:
        vp = quantize_params(vp)       # the blocks; the merger stays bf16
    nh, nw = smart_resize(side, side, factor=56, max_pixels=4 * 224 * 224)
    gh, gw = nh // 14, nw // 14
    t = clip // 2
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(
        0, 255, (N_BANK, clip, nh, nw, 3), dtype=np.uint8)).to(device)
    pd = vit.in_channels * vit.temporal_patch_size * vit.patch_size ** 2
    patches = torch.from_numpy(rng.normal(size=(
        N_BANK, t * gh * gw, pd)).astype(np.float32)).to(device).to(
            torch.bfloat16)
    return Ingest(vp, vit, FlashMemoryConfig(), t, gh, gw, frames, patches,
                  device)


def draws_for(device: torch.device) -> Callable:
    """n -> [n] uniforms from a seeded generator on `device`."""
    g = torch.Generator(device=device).manual_seed(0)
    return lambda n: torch.rand(n, generator=g, device=device)


def head(x) -> torch.Tensor:
    """A scalar that reads every output's first element (so nothing a stage
    returns is dead), f32."""
    leaves = x if isinstance(x, (tuple, list)) else (x,)
    return sum(t.reshape(-1)[0].float() for t in leaves
               if torch.is_tensor(t) and t.numel())


def time_stage(name: str, step: Callable, iters: int, trials: int,
               device: torch.device, graph: bool = True) -> dict:
    """`step(i)` -> its outputs, chained over `iters` calls; seconds a call
    by replay (None where `graph` is off, and on the CPU) and eagerly."""
    def loop():
        acc = torch.zeros((), device=device)
        for i in range(iters):
            acc = acc + head(step(i))
        return acc
    graph = graph and device.type == "cuda"
    s = graph_seconds(loop, device, trials) / iters if graph else None
    return {"s": s, "eager_s": eager_seconds(loop, device, trials) / iters}


def snapshot(out):
    """The whole snapshot of an update: returning only part of it would let
    the JAX script's compiler drop the spatial path, so both read all."""
    return (out.spa_positions, out.tem_positions, out.spa_x, out.tem_x)


def stage_steps(ing: Ingest, stages: List[str]) -> dict:
    """name -> (step(i), graph capturable) for each stage asked for; the
    memory stages carry their state across calls."""
    draws = draws_for(ing.device)
    steps = {}
    if "pre" in stages:
        steps["pre"] = lambda i: ing.preprocess(ing.frames[i % N_BANK])
    if "vit" in stages:          # the pool once a clip, outside the loop
        allp = [ing.streams(p) for p in ing.patches]
        steps["vit"] = lambda i: ing.blocks(allp[i % N_BANK])
    if "mem" in stages:
        g = torch.Generator(device=ing.device).manual_seed(2)
        D = ing.vit.hidden_size
        hid = torch.randn((N_BANK, ing.t * (ing.p_full + ing.p_small), D),
                          generator=g, device=ing.device).to(torch.bfloat16)
        box = [ing.state(saturated=True)]

        def mem(i):
            box[0], out = ing.update(box[0], hid[i % N_BANK], draws)
            return snapshot(out)
        steps["mem"] = mem
    if "merge" in stages:
        fm = ing.fm
        n_vis = fm.dam_grid_len * ing.p_full + fm.csm_grid_len * ing.p_small
        g = torch.Generator(device=ing.device).manual_seed(3)
        vis = torch.randn((N_BANK, n_vis, ing.vit.hidden_size), generator=g,
                          device=ing.device).to(torch.bfloat16)
        steps["merge"] = lambda i: ing.merge(vis[i % N_BANK])
    if "previt" in stages:
        steps["previt"] = lambda i: ing.encode(
            ing.preprocess(ing.frames[i % N_BANK]))
    for name, pre in (("full", True), ("vitmem", False)):
        if name not in stages:
            continue
        box = [ing.state(saturated=name == "vitmem")]

        def whole(i, box=box, pre=pre):
            p = (ing.preprocess(ing.frames[i % N_BANK]) if pre
                 else ing.patches[i % N_BANK])
            box[0], out = ing.update(box[0], ing.encode(p), draws)
            return snapshot(out)
        steps[name] = whole
    return steps


LABELS = {"pre": "device preprocess", "vit": "ViT encode (dual-res)",
          "mem": "flash memory update", "merge": "patch merger (full memory)",
          "full": "FULL ingest (pre+vit+mem)", "previt": "pre+pool+ViT",
          "vitmem": "ViT+memory"}
KEYS = {"pre": "preprocess_ms", "vit": "vit_ms", "mem": "memory_update_ms",
        "merge": "merger_ms", "full": "full_ms", "previt": "previt_ms",
        "vitmem": "vitmem_ms"}


def report(label: str, r: dict, flops: Optional[float]) -> str:
    g = "graph n/a" if r["s"] is None else f"{r['s'] * 1e3:8.2f} ms graph"
    rate = (f" {flops / r['s'] / 1e12:6.1f} TF/s" if flops and r["s"]
            else "")
    return f"{label:32s} {g}{rate}  eager {r['eager_s'] * 1e3:8.2f} ms"


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clip", type=int, default=8)
    ap.add_argument("--side", type=int, default=224)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--stages", type=str, default="all",
                    help="comma list of " + ",".join(STAGES))
    ap.add_argument("--int8-vit", action="store_true",
                    help="int8 ViT blocks with w8a8 products at prefill "
                         "rows")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the ViT to this many layers (default 32)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    from ..models import layers
    from ..weights.quantize import enable_w8a8_prefill
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    stages = list(STAGES) if args.stages == "all" else \
        args.stages.split(",")
    ing = setup(args.side, args.clip, args.layers, args.int8_vit, device)
    flops = ing.vit_flops()
    print(f"device: {card_line(device)}", file=sys.stderr)
    print(f"clip={args.clip} grid=({ing.t},{ing.gh},{ing.gw}) tokens="
          f"{ing.t * (ing.p_full + ing.p_small)} ViT {flops / 1e12:.2f} "
          f"TFLOP/clip", file=sys.stderr)
    was = layers.W8A8_PREFILL
    enable_w8a8_prefill(args.int8_vit)
    out = {"metric": "torch_ingest_profile", "device": card_line(device),
           "clip": args.clip, "side": args.side, "int8_vit": args.int8_vit}
    try:
        for name, step in stage_steps(ing, stages).items():
            r = time_stage(name, step, args.iters, args.trials, device,
                           graph=name not in GRAPH_NA)
            vit = name in ("vit", "previt", "full", "vitmem")
            print(report(LABELS[name], r, flops if vit else None),
                  file=sys.stderr, flush=True)
            out[KEYS[name]] = None if r["s"] is None else r["s"] * 1e3
            out[KEYS[name].replace("_ms", "_eager_ms")] = r["eager_s"] * 1e3
            if name == "full":
                out["fps"] = args.clip / r["eager_s"]
    finally:
        enable_w8a8_prefill(was)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
