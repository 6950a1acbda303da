"""Probe: where the whole ingest loses time against the sum of its stages.

Counterpart of scripts/probe_ingest_fusion.py: the progressive
compositions of the ingest (pre+vit, pre+vit+mem, the same returning the
new state too, the full ingest with the patch merger, and the merger
alone) under profile_ingest.py's harness: chained loops of --iters calls,
fresh clips each call, the memory state carried across calls, best of
--trials, timed eagerly between CUDA events and, where the loop can be
captured, by CUDA-graph replay: only the merger alone can be (the
preprocess copies host constants each call, the memory update reads a
count on the host; profile_ingest.py times the ViT alone by replay). The JAX probe's variant with an
optimization barrier before the merger has no eager counterpart (nothing
fuses across the ops here) and is left out.

Prints a line a composition and one JSON line (metric
`torch_ingest_fusion`, ms a clip) with the card's name and power limit.

Usage: python -m flash_vstream_tpu_torch.scripts.probe_ingest_fusion
           [--clip 8] [--side 224] [--iters 20]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core.device import resolve_device
from .profile_ingest import (N_BANK, draws_for, setup, snapshot,
                             time_stage)
from .timing import card_line


def compositions(ing) -> dict:
    """name -> (step(i), graph capturable)."""
    from ..models.flash_memory import cat_spa_tem
    draws = draws_for(ing.device)
    fm = ing.fm
    n_vis = fm.dam_grid_len * ing.p_full + fm.csm_grid_len * ing.p_small
    g = torch.Generator(device=ing.device).manual_seed(3)
    vis = torch.randn((N_BANK, n_vis, ing.vit.hidden_size), generator=g,
                      device=ing.device).to(torch.bfloat16)

    def enc(i):
        return ing.encode(ing.preprocess(ing.frames[i % N_BANK]))

    def with_state(keep):
        box = [ing.state()]

        def step(i):
            box[0], out = ing.update(box[0], enc(i), draws)
            return keep(box[0], out)
        return step
    return {
        "pre+vit": (enc, False),
        "pre+vit+mem": (with_state(lambda st, out: out.tem_x), False),
        "pre+vit+mem (+state out)": (
            with_state(lambda st, out: (st.tem_x, *snapshot(out))), False),
        "full (pre+vit+mem+merge)": (with_state(
            lambda st, out: ing.merge(cat_spa_tem(out.spa_x, out.tem_x))),
            False),
        "merger alone": (lambda i: ing.merge(vis[i % N_BANK]), True),
    }


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clip", type=int, default=8)
    ap.add_argument("--side", type=int, default=224)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the ViT to this many layers (default 32)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    ing = setup(args.side, args.clip, args.layers, False, device)
    print(f"device: {card_line(device)}", file=sys.stderr)
    out = {"metric": "torch_ingest_fusion", "device": card_line(device),
           "clip": args.clip, "side": args.side}
    for name, (step, graph) in compositions(ing).items():
        r = time_stage(name, step, args.iters, args.trials, device, graph)
        g = ("graph n/a" if r["s"] is None
             else f"{r['s'] * 1e3:8.2f} ms graph")
        print(f"{name:36s} {g}  eager {r['eager_s'] * 1e3:8.2f} ms/iter",
              file=sys.stderr, flush=True)
        out[name] = {"graph_ms": None if r["s"] is None else r["s"] * 1e3,
                     "eager_ms": r["eager_s"] * 1e3}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
