"""Data parallelism with ZeRO stages 1, 2 and 3 and moment offload in the
port's Trainer (flash_vstream_tpu_torch/train/trainer.py), across gloo
ranks on the CPU, against the JAX Trainer on its virtual CPU mesh.

tests/test_trainer_parallel.py's model and loss (2 layers, hidden 32,
`lm_loss`), 3 steps of a global batch of 4 with grad_accum 2 (the first at
lr 0), clipping and weight decay on. One spawn of 2 ranks and one of 4,
each running every case: ZeRO 1, 2, 3 (stage 3 with a frozen tree) and
each again with --offload-moments; JAX runs the same stage on a dp x 1
mesh of as many of its devices (its offload equals its resident trainer on
the CPU, test_trainer_parallel.py). Held: the losses within 1e-5
relative, every leaf after the steps within 5e-4 relative and 5e-5
absolute, stage 3 against stage 2 at the same limits, the moments (stages
1, 2) and the parameters (stage 3) 1/dp of the whole on the dim JAX's
`zero_shardings` picks, the frozen tree sharded at stage 3, and a
checkpoint written at world 2 under ZeRO-3 (gathered, rank 0) resumed at
world 1 for the third step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from flash_vstream_tpu.core.config import LLMConfig
from flash_vstream_tpu.models.llm import (cross_entropy_loss, decoder_forward,
                                          embed_tokens, init_llm_params,
                                          lm_head)
from flash_vstream_tpu.parallel.sharding import create_mesh, zero_shardings
from flash_vstream_tpu.train.trainer import TrainConfig as JConfig
from flash_vstream_tpu.train.trainer import Trainer as JTrainer
from flash_vstream_tpu_torch.core.config import LLMConfig as TLLMConfig
from flash_vstream_tpu_torch.parallel.collectives import spawn
from flash_vstream_tpu_torch.train.checkpoint import restore_checkpoint
from flash_vstream_tpu_torch.train.lora import tree_leaves_with_path
from flash_vstream_tpu_torch.train.trainer import TrainConfig, Trainer
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

CFG_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2)
CFG = LLMConfig(**CFG_KW)
TKW = dict(learning_rate=1e-2, total_steps=20, grad_accum=2,
           warmup_ratio=0.0, weight_decay=0.01)
CASES = [(1, False, TKW, False), (2, False, TKW, False),
         (3, False, TKW, True), (1, True, TKW, False),
         (2, True, TKW, False), (3, True, TKW, False)]
WORLDS = (2, 4)


def _params():
    return jax.tree.map(np.asarray,
                        init_llm_params(jax.random.PRNGKey(0), CFG))


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        ids = rng.integers(0, 128, size=(2, 4, 16))
        out.append({"ids": ids, "labels": ids})
    return out


def lm_loss(params, batch, key):
    ids, labels = batch["ids"], batch["labels"]
    pos = jnp.broadcast_to(jnp.arange(ids.shape[1])[None], ids.shape)
    h, _ = decoder_forward(params, CFG, embed_tokens(params, ids), pos)
    return cross_entropy_loss(lm_head(params, CFG, h), labels)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"dp{world}")
        ckpt = str(d / "ckpt") if world == 2 else None
        spawn(torch_ranks.train_cases, world, str(d), CFG_KW, _params(),
              _batches(), CASES, ckpt, 2, init_file=str(d / "init"))
        out[world] = dict(
            ranks=[torch.load(d / f"rank{r}.pt", weights_only=False)
                   for r in range(world)], ckpt=ckpt)
    return out


_JAX = {}


def _jax(dp, stage):
    """The JAX Trainer's losses and leaves after each step (its stages 1
    and 2 are one program: moments sharded over dp)."""
    stage = max(stage, 2)
    if (dp, stage) not in _JAX:
        tr = JTrainer(lm_loss, jax.tree.map(jnp.asarray, _params()),
                      JConfig(zero_stage=stage, **TKW),
                      mesh=create_mesh(dp=dp, tp=1))
        losses, leaves = [], []
        for s, b in enumerate(_batches()):
            losses.append(tr.run_step(jax.tree.map(jnp.asarray, b),
                                      jax.random.PRNGKey(s)))
            leaves.append({jax.tree_util.keystr(p): np.asarray(v)
                           for p, v in jax.tree_util.tree_leaves_with_path(
                               tr.params)})
        _JAX[(dp, stage)] = losses, leaves
    return _JAX[(dp, stage)]


def _keystr(path):
    return "".join(f"['{k}']" for k in path.split("/"))


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


def _hold(got: dict, want: dict):
    for p, x in got.items():
        np.testing.assert_allclose(np.asarray(x), want[_keystr(p)],
                                   rtol=5e-4, atol=5e-5, err_msg=p)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_trainer_matches_jax(ranks, world, case):
    stage, offload = CASES[case][:2]
    res = ranks[world]["ranks"]
    losses, leaves = _jax(world, stage)
    for r in range(world):          # every rank reports the global loss
        np.testing.assert_allclose(res[r][case]["losses"], losses, rtol=1e-5)
    _hold(_leaves(res[0][case]["params"]), leaves[-1])
    moved = [p for p, x in _leaves(res[0][case]["params"]).items()
             if not np.array_equal(x, _leaves(_params())[p])]
    assert moved, "no leaf moved"


@pytest.mark.parametrize("world", WORLDS)
def test_stage3_equals_stage2(ranks, world):
    res = ranks[world]["ranks"][0]
    for s2, s3 in ((1, 2), (4, 5)):           # resident, offloaded
        np.testing.assert_allclose(res[s3]["losses"], res[s2]["losses"],
                                   rtol=1e-5)
        want = {_keystr(p): x for p, x in _leaves(res[s2]["params"]).items()}
        _hold(_leaves(res[s3]["params"]), want)


@pytest.mark.parametrize("world", WORLDS)
def test_shards_are_one_dp_th(ranks, world):
    """Moments (stages 1, 2) and parameters (stage 3) hold 1/dp of each
    leaf on the dim JAX's zero_shardings splits; whole elsewhere; the
    frozen tree rests sharded at stage 3."""
    params = _params()
    specs = {jax.tree_util.keystr(p): s.spec for p, s in
             jax.tree_util.tree_leaves_with_path(
                 zero_shardings(create_mesh(dp=world, tp=1), params))}
    whole = {p: x.shape for p, x in _leaves(params).items()}
    split = 0
    for r in range(world):
        for case, (stage, _, _, frozen) in enumerate(CASES):
            res = ranks[world]["ranks"][r][case]
            shapes = res["shards"] if stage == 3 else res["mu"]
            for p, shape in shapes.items():
                want = list(whole[p])
                spec = tuple(specs[_keystr(p)]) + (None,) * len(want)
                if "dp" in spec:
                    want[spec.index("dp")] //= world
                    split += 1
                assert tuple(want) == tuple(shape), (p, shape, spec)
            if frozen:
                assert res["frozen_sharded"] is True
    assert split


def test_resume_at_world_1(ranks):
    """The ZeRO-3 offload run at world 2 checkpoints after step 2 (the
    whole state, gathered, rank 0 writes it); a ZeRO-2 trainer at world 1
    loads it and takes step 3 over the whole batch: its loss and leaves are
    JAX's third step's."""
    step, payload = restore_checkpoint(ranks[2]["ckpt"], map_location="cpu")
    assert step == 2
    tr = Trainer(torch_ranks.lm_loss_fn(TLLMConfig(**CFG_KW)),
                 params_from_numpy(_params(), "cpu"), TrainConfig(**TKW))
    tr.load_state(payload["params"], payload["opt_state"])
    assert tr.opt_state["count"] == 2
    loss = tr.run_step(_batches()[2], 2)
    losses, leaves = _jax(2, 3)
    np.testing.assert_allclose(loss, losses[2], rtol=1e-5)
    _hold({p: x.detach().numpy() for p, x in _leaves(tr.params).items()},
          leaves[2])
