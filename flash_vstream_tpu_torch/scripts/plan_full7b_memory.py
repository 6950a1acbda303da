"""Full-parameter 7B finetune memory plan (LLaVA stage 2) on a dp x tp mesh.

Port of scripts/plan_full7b_memory.py. The JAX script AOT-compiles the
stage-2 step against a TPU topology and prints XLA's per-chip memory
analysis; eager PyTorch has no such analysis, so this script reckons the
per-rank bytes from the specs the port's Trainer lays the state out by
(train/trainer.py): `LLM_RULES` split a leaf over tp
(`parallel.tensor.tp_spec`), ZeRO splits the largest free dim over dp
(`parallel.sharding._zero_spec`), the recipe is the JAX script's (the
decoder, the projector and the NTM train, `frozen=(r"^vit",)`, ZeRO 3,
as the JAX script sets it). `VStreamLLaVAConfig()`'s parameters are built
on the `meta` device, so nothing is materialised and the 7B plan runs on
any host.

For each dp size of `--mesh` it prints one JSON row: the per-rank bytes of
the parameters and the gradients (a rank's ZeRO-3 shard), the Adam
moments on the card (0 with --offload-moments; their host bytes beside)
and `argument_gb_per_chip` (parameters + moments on the card: what JAX's
memory analysis names so); a reckoning of a remat step's activations (the
checkpointed layer inputs, one layer's recompute and backward, one
cross-entropy chunk, one gathered ZeRO-3 layer), named as a reckoning;
their sum, and `fits_80gb` (under 76 GiB of the H100's 80 GB, as JAX's
`fits_16gb` left 0.8 of 16 GiB).

    python -m flash_vstream_tpu_torch.scripts.plan_full7b_memory \\
        [--mesh 1 2 4 8] [--tp 1] [--seq 2048] [--frames 64] \\
        [--batch-per-chip 1] [--grad-accum 1] [--offload-moments]
    python -m flash_vstream_tpu_torch.scripts.plan_full7b_memory --tiny
    python -m flash_vstream_tpu_torch.scripts.plan_full7b_memory \\
        --measure --layers 4 --mesh 1        # one real step on the card

`--measure` runs one real step at `--layers` decoder layers on the card at
world 1 (random bf16 weights from the seed, features at the plan's shape)
and prints `torch.cuda.max_memory_allocated` beside the reckoning of the
same depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import types

import numpy as np
import torch

from ..core.config import VStreamLLaVAConfig, tiny_llava_config
from ..models.vstream_llava import init_llava_params, star_valid_counts
from ..parallel.sharding import LLM_RULES, _zero_spec
from ..parallel.tensor import tp_spec
from ..train.lora import tree_leaves_with_path
from ..train.trainer import TrainConfig, label_params

GIB = 1 << 30
BUDGET_GIB = 76.0            # of the H100's 80 GB: room for the allocator
CE_CHUNK = 512               # train.py's cross-entropy chunk


def stage2_config(grad_accum: int = 1,
                  offload_moments: bool = False) -> TrainConfig:
    """The JAX script's stage-2 recipe (scripts/plan_full7b_memory.py:
    92-94), ZeRO 3."""
    return TrainConfig(learning_rate=2e-5, total_steps=100,
                       grad_accum=grad_accum, zero_stage=3,
                       frozen=(r"^vit",), offload_moments=offload_moments)


def cut_config(cfg, num_layers: int = None):
    """`cfg` with the decoder cut to `num_layers` where given."""
    if num_layers is None:
        return cfg
    return cfg.replace(llm=dataclasses.replace(cfg.llm,
                                               num_layers=num_layers))


def meta_params(cfg) -> dict:
    """`cfg`'s parameters in bf16 on the `meta` device (shapes only)."""
    return init_llava_params(cfg, None, "meta", dtype=torch.bfloat16)


def state_bytes(params: dict, tcfg: TrainConfig, dp: int, tp: int) -> dict:
    """Per-rank bytes of the parameters, the gradients and the Adam moments
    at rest, each leaf split as the Trainer splits it on a dp x tp mesh
    at ZeRO 3."""
    mesh = types.SimpleNamespace(shape={"dp": dp, "tp": tp},
                                 axis_names=("dp", "tp"))
    labels = label_params(params, tcfg)
    mu_dtype = getattr(torch, tcfg.mu_dtype) if tcfg.mu_dtype else None
    out = dict(params=0, grads=0, mu=0, nu=0)
    for p, x in tree_leaves_with_path(params):
        if not isinstance(x, torch.Tensor):
            continue
        n = x.numel()
        if tp > 1 and tp_spec(p, x.shape, mesh) is not None:
            n //= tp
        zero = dp > 1 and "dp" in _zero_spec((p,), x, mesh, LLM_RULES)
        shard = n // dp if zero else n
        out["params"] += shard * x.element_size()
        if labels[p] == "frozen":
            continue
        out["grads"] += shard * x.element_size()
        out["mu"] += shard * (mu_dtype or x.dtype).itemsize
        out["nu"] += shard * x.element_size()
    return out


def activation_bytes(cfg, B: int, S: int, tp: int, stage3: bool,
                     params: dict) -> dict:
    """A reckoning of a remat step's activation bytes on one rank (bf16
    activations, f32 logits): the checkpointed input of every decoder
    layer and the final norm's; one layer's recompute and its backward
    (the norms' outputs and the q, k, v and attention outputs at D / tp
    each, the MLP's gate, up and product at I / tp, each with its
    gradient); one cross-entropy chunk's logits, log-softmax and gradient
    in f32; and at ZeRO-3 one layer's weights gathered whole, with their
    gradients before the reduce-scatter."""
    L = cfg.llm
    D, I, V = L.hidden_size, L.intermediate_size, L.vocab_size
    layer_inputs = (L.num_layers + 1) * B * S * D * 2
    layer_work = 2 * B * S * (2 * D + 4 * D // tp + 3 * I // tp) * 2
    ce = 3 * B * min(S, CE_CHUNK) * V * 4
    gathered = 0
    if stage3:
        per_layer = sum(x.numel() // x.shape[0] for p, x in
                        tree_leaves_with_path(params["llm"]["layers"]))
        gathered = 2 * per_layer // tp * 2
    return dict(layer_inputs=layer_inputs, layer_work=layer_work, ce=ce,
                gathered_layer=gathered)


def plan(cfg, dp: int, tp: int = 1, *, seq: int, frames: int,
         batch_per_chip: int = 1, grad_accum: int = 1,
         offload_moments: bool = False, num_layers: int = None) -> dict:
    """One mesh's row (see the module note)."""
    cfg = cut_config(cfg, num_layers)
    params = meta_params(cfg)
    tcfg = stage2_config(grad_accum, offload_moments)
    n_mem = sum(star_valid_counts(cfg, frames))
    S = max(seq, n_mem + 64)
    st = state_bytes(params, tcfg, dp, tp)
    moments = st["mu"] + st["nu"]
    on_card = 0 if offload_moments else moments
    act = activation_bytes(cfg, batch_per_chip, S, tp, dp > 1, params)
    total = st["params"] + st["grads"] + on_card + sum(act.values())
    return {
        "ranks": dp * tp, "dp": dp, "tp": tp, "zero_stage": 3,
        "offload_moments": offload_moments,
        "batch_per_chip": batch_per_chip, "seq": S, "frames": frames,
        "decoder_layers": cfg.llm.num_layers,
        "params_bytes": st["params"], "grads_bytes": st["grads"],
        "mu_bytes": st["mu"], "nu_bytes": st["nu"],
        "moments_host_bytes": moments if offload_moments else 0,
        "params_gb_per_chip": round(st["params"] / GIB, 2),
        "grads_gb_per_chip": round(st["grads"] / GIB, 2),
        "moments_gb_per_chip": round(on_card / GIB, 2),
        "argument_gb_per_chip": round((st["params"] + on_card) / GIB, 2),
        "activations_reckoned_gb": {k: round(v / GIB, 2)
                                    for k, v in act.items()},
        "total_reckoned_gb_per_chip": round(total / GIB, 2),
        "fits_80gb": total < BUDGET_GIB * GIB,
    }


def measure(cfg, args, seed: int = 0) -> dict:
    """One real stage-2 step at world 1 on the card at `args.layers`
    decoder layers: the peak `torch.cuda.max_memory_allocated` beside the
    plan's reckoning of the same depth."""
    from ..core.device import resolve_device
    from ..train.finetune_flash import default_kmeans_draws
    from ..train.train import make_losses
    from ..train.trainer import Trainer
    dev = resolve_device("cuda")
    cut = cut_config(cfg, args.layers)
    params = init_llava_params(cut, torch.Generator(device=dev).manual_seed(
        seed), dev, dtype=torch.bfloat16)
    T, B, A = args.frames, args.batch_per_chip, args.grad_accum
    n_mem = sum(star_valid_counts(cfg, T))
    S = max(args.seq, n_mem + 64)
    pre = 16
    rng = np.random.default_rng(seed)
    V = cfg.llm.vocab_size
    P, Dv = cfg.star.current_size ** 2, cfg.projector.effective_input_dim
    ids = rng.integers(1, V, size=(A, B, S - n_mem + 1))
    labels = rng.integers(1, V, size=(A, B, S))
    labels[..., :pre + n_mem] = -100
    batch = {"input_ids": ids, "labels": labels,
             "segments": np.zeros((A, B, S), np.int32),
             "images": rng.standard_normal((A, B, T, P, Dv),
                                           dtype=np.float32),
             "n_frames": np.full((A, B), T)}
    loss = make_losses(cut, dev, pre, n_mem, default_kmeans_draws)["video"]
    tcfg = stage2_config(A, args.offload_moments)
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(loss, params, tcfg)
    value = tr.run_step(batch, 0)
    torch.cuda.synchronize(dev)
    row = plan(cfg, 1, 1, seq=args.seq, frames=T, batch_per_chip=B,
               grad_accum=A, offload_moments=args.offload_moments,
               num_layers=args.layers)
    row.update(measured=True, loss=value,
               measured_peak_gb=round(
                   torch.cuda.max_memory_allocated(dev) / GIB, 2),
               device=torch.cuda.get_device_name(dev))
    return row


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="dp sizes to plan (ranks = dp x tp)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width of every planned mesh")
    ap.add_argument("--seq", type=int, default=2048,
                    help="model_max_length (reference stage 2: 2048)")
    ap.add_argument("--frames", type=int, default=64,
                    help="video feature frames per sample (train bucket)")
    ap.add_argument("--batch-per-chip", type=int, default=1)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--offload-moments", action="store_true",
                    help="the Adam moments rest in pinned host memory")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_llava_config() (a smoke test), seq 128, "
                         "8 frames")
    ap.add_argument("--measure", action="store_true",
                    help="also run one real step on the card at --layers")
    ap.add_argument("--layers", type=int, default=4,
                    help="decoder depth of the --measure step")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    return ap


def main(argv=None) -> list:
    args = make_parser().parse_args(argv)
    cfg = tiny_llava_config() if args.tiny else VStreamLLaVAConfig()
    if args.tiny:
        args.seq, args.frames = 128, 8
    n = sum(x.numel() for _, x in tree_leaves_with_path(meta_params(cfg)))
    print(f"model: {n / 1e9:.2f}B params (bf16), seq {args.seq}, "
          f"{args.frames} feature frames", file=sys.stderr)
    rows = []
    for dp in args.mesh:
        rows.append(plan(cfg, dp, args.tp, seq=args.seq, frames=args.frames,
                         batch_per_chip=args.batch_per_chip,
                         grad_accum=args.grad_accum,
                         offload_moments=args.offload_moments))
        print(json.dumps(rows[-1]), flush=True)
    if args.measure:
        rows.append(measure(cfg, args))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
