"""Tensor-parallel training in the port's Trainer (flash_vstream_tpu_torch/
parallel/tensor.py, train/trainer.py) across gloo ranks on the CPU,
against the JAX Trainer on create_mesh(dp, tp) over as many of its virtual
CPU devices.

tests/test_trainer_parallel.py's model and loss (2 layers, hidden 32, 4
heads and 2 kv heads, `lm_loss`: embed and lm_head vocab-split), 3 steps of
a global batch of 4 with grad_accum 2, clipping and weight decay on. One
spawn of 2 ranks (dp 1 x tp 2) and one of 4 (dp 1 x tp 4, where each kv
head is cut over two ranks and gathered on use; then dp 2 x tp 2), each
mesh running ZeRO 1, 2, 3 (3 with a frozen tree, and again with
--offload-moments). Held: the losses within 1e-5 relative, every leaf
after the steps within 5e-4 relative and 5e-5 absolute; each rank's
resting parameters, moments and frozen gate split as JAX's specs name
(1/tp on 'tp', and 1/dp more on 'dp' where ZeRO splits); the first step's
gradient of every leaf left whole equal bit for bit on the ranks of a tp
group; a checkpoint written at dp 2 x tp 2 under ZeRO-3 with the offload
resumed at world 1 for the third step. A tp-2 forward of the CLIP tower
and of the Qwen2-VL ViT (its varlen and its frame-batched blocks) is held
to the whole tower."""
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
from flash_vstream_tpu.parallel.sharding import (create_mesh, param_shardings,
                                                 zero_shardings)
from flash_vstream_tpu.train.trainer import TrainConfig as JConfig
from flash_vstream_tpu.train.trainer import Trainer as JTrainer
from flash_vstream_tpu_torch.core.config import LLMConfig as TLLMConfig
from flash_vstream_tpu_torch.core.config import VitConfig
from flash_vstream_tpu_torch.models.clip_vit import init_clip_params
from flash_vstream_tpu_torch.models.qwen2_vit import init_qwen_vit_params
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
         (3, False, TKW, True), (3, True, TKW, False)]
# (world, [tp of each mesh]): dp = world / tp; dp 2 x tp 2 runs last, so
# its ZeRO-3 offload case writes the checkpoint
WORLDS = {2: [2], 4: [4, 2]}
MESHES = [(1, 2), (1, 4), (2, 2)]               # (dp, tp)
CLIP_KW = dict(hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=4, patch_size=14, image_size=28, select_layer=-1)
QVIT_KW = dict(hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=4, patch_size=14, image_size=0,
               temporal_patch_size=2, spatial_merge_size=2, use_rope_2d=True,
               merger_out_dim=64, hidden_act="gelu")
QVIT_GRID = (2, 4, 4)


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


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def _towers():
    g = torch.Generator().manual_seed(3)
    clip = _np(init_clip_params(VitConfig(**CLIP_KW), g, "cpu"))
    qvit = _np(init_qwen_vit_params(VitConfig(**QVIT_KW), g, "cpu"))
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    t, h, w = QVIT_GRID
    patches = rng.standard_normal(
        (t * h * w, 3 * 2 * 14 * 14)).astype(np.float32)
    return clip, images, qvit, patches


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world, tps in WORLDS.items():
        d = tmp_path_factory.mktemp(f"tp{world}")
        ckpt = str(d / "ckpt") if world == 4 else None
        spawn(torch_ranks.tp_train_cases, world, str(d), CFG_KW, _params(),
              _batches(), [(tp, CASES) for tp in tps], ckpt, 2,
              init_file=str(d / "init"))
        res = [torch.load(d / f"rank{r}.pt", weights_only=False)
               for r in range(world)]
        for i, tp in enumerate(tps):
            out[(world // tp, tp)] = [
                r[i * len(CASES):(i + 1) * len(CASES)] for r in res]
        if ckpt:
            out["ckpt"] = ckpt
    return out


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    d = tmp_path_factory.mktemp("towers")
    clip, images, qvit, patches = _towers()
    spawn(torch_ranks.tp_tower_forwards, 2, str(d), CLIP_KW, clip, images,
          QVIT_KW, qvit, patches, QVIT_GRID, init_file=str(d / "init"))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


_JAX = {}


def _jax(dp, tp, stage):
    """The JAX Trainer's losses and leaves after each step on
    create_mesh(dp, tp) (its stages 1 and 2 are one program, and at dp 1
    stage 3 too: zero_shardings adds no 'dp' axis there; its offload
    equals its resident trainer on the CPU)."""
    stage = max(stage, 2) if dp > 1 else 2
    if (dp, tp, stage) not in _JAX:
        tr = JTrainer(lm_loss, jax.tree.map(jnp.asarray, _params()),
                      JConfig(zero_stage=stage, **TKW),
                      mesh=create_mesh(dp=dp, tp=tp))
        losses, leaves = [], []
        for s, b in enumerate(_batches()):
            losses.append(tr.run_step(jax.tree.map(jnp.asarray, b),
                                      jax.random.PRNGKey(s)))
            leaves.append({jax.tree_util.keystr(p): np.asarray(v)
                           for p, v in jax.tree_util.tree_leaves_with_path(
                               tr.params)})
        _JAX[(dp, tp, stage)] = losses, leaves
    return _JAX[(dp, tp, stage)]


def _keystr(path):
    return "".join(f"['{k}']" for k in path.split("/"))


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


def _hold(got: dict, want: dict):
    for p, x in got.items():
        np.testing.assert_allclose(np.asarray(x), want[_keystr(p)],
                                   rtol=5e-4, atol=5e-5, err_msg=p)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_trainer_matches_jax(ranks, mesh, case):
    dp, tp = mesh
    res = ranks[mesh]
    losses, leaves = _jax(dp, tp, CASES[case][0])
    for r in range(dp * tp):        # every rank reports the global loss
        np.testing.assert_allclose(res[r][case]["losses"], losses, rtol=1e-5)
    _hold(_leaves(res[0][case]["params"]), leaves[-1])
    moved = [p for p, x in _leaves(res[0][case]["params"]).items()
             if not np.array_equal(x, _leaves(_params())[p])]
    assert moved, "no leaf moved"


def _specs(fn, dp, tp):
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_leaves_with_path(
                fn(create_mesh(dp=dp, tp=tp), _params()))}


def _split(shape, spec, dp, tp):
    want = list(shape)
    for i, a in enumerate(spec):
        want[i] //= {"dp": dp, "tp": tp}.get(a, 1)
    return tuple(want)


@pytest.mark.parametrize("mesh", MESHES)
def test_shards_split_as_jax_specs(ranks, mesh):
    """Each rank's resting parameters (stages 1 and 2: JAX's
    param_shardings, 1/tp on 'tp'; stage 3: its zero_shardings, 1/(dp x
    tp) where both split), its moments (zero_shardings) and its frozen
    gate (stage 3) have the shapes of those specs; the embed, the lm_head
    and every projection of the layers are split."""
    dp, tp = mesh
    whole = {p: x.shape for p, x in _leaves(_params()).items()}
    plain = _specs(param_shardings, dp, tp)
    zero = _specs(zero_shardings, dp, tp)
    split = set()
    for r in range(dp * tp):
        for case, (stage, _, _, frozen) in enumerate(CASES):
            res = ranks[mesh][r][case]
            rest = zero if stage == 3 and dp > 1 else plain
            for p, shape in res["shards"].items():
                want = _split(whole[p], rest[_keystr(p)], dp, tp)
                assert want == shape, (p, shape, rest[_keystr(p)])
                if want != whole[p]:
                    split.add(p)
            for p, shape in res["mu"].items():
                assert _split(whole[p], zero[_keystr(p)], dp, tp) == shape, p
            if frozen:
                p = "layers/mlp/gate/w"
                assert res["frozen_gate"] == _split(
                    whole[p], rest[_keystr(p)], dp, tp)
    assert {"embed", "lm_head", "layers/attn/wk/w", "layers/attn/wo/w",
            "layers/mlp/down/w", "layers/mlp/gate/w"} <= split, split


@pytest.mark.parametrize("mesh", MESHES)
def test_whole_leaf_gradients_equal_over_tp(ranks, mesh):
    """A leaf left whole (the norms) gets the same gradient on every rank
    of a tp group, bit for bit: the copy-to regions all-reduce what flows
    into each replicated input, so the Trainer reduces nothing over tp."""
    dp, tp = mesh
    res = ranks[mesh]
    for case in range(len(CASES)):
        for r in range(dp * tp):
            mine = res[r][case]["whole_grads"]
            first = res[r - r % tp][case]["whole_grads"]
            assert set(mine) == {"final_norm", "layers/attn_norm",
                                 "layers/mlp_norm"}
            for p, g in mine.items():
                np.testing.assert_array_equal(g, first[p], err_msg=p)


def test_resume_at_world_1(ranks):
    """The dp 2 x tp 2 ZeRO-3 offload run checkpoints after step 2 (the
    whole state, gathered over dp, then over tp; rank 0 writes it); a
    ZeRO-2 trainer at world 1 loads it and takes step 3 over the whole
    batch: its loss and leaves are JAX's third step's."""
    step, payload = restore_checkpoint(ranks["ckpt"], map_location="cpu")
    assert step == 2
    tr = Trainer(torch_ranks.lm_loss_fn(TLLMConfig(**CFG_KW)),
                 params_from_numpy(_params(), "cpu"), TrainConfig(**TKW))
    tr.load_state(payload["params"], payload["opt_state"])
    assert tr.opt_state["count"] == 2
    loss = tr.run_step(_batches()[2], 2)
    losses, leaves = _jax(2, 2, 3)
    np.testing.assert_allclose(loss, losses[2], rtol=1e-5)
    _hold({p: x.detach().numpy() for p, x in _leaves(tr.params).items()},
          leaves[2])


@pytest.mark.parametrize("which", ["clip", "blocks", "frames"])
def test_tower_forward_matches_whole(towers, which):
    """CLIP's tower and the Qwen2-VL ViT split over tp 2 (q/k/v, fc1 by
    columns, wo and fc2 by rows: their local heads) give the whole tower's
    features on both ranks."""
    for r in towers:
        whole, split = r[which]
        assert r["n_split"] == 10     # q, k, v (w, b), wo, fc1 (w, b), fc2
        np.testing.assert_allclose(split, whole, rtol=1e-5, atol=1e-5)


def _fake_tp(n):
    """A tp group of n ranks of which this process is rank 0, with no
    process group: a split and a raise need no collective."""
    from flash_vstream_tpu_torch.parallel.collectives import Group
    from flash_vstream_tpu_torch.parallel.sharding import RankMesh
    return RankMesh(None, Group([0]), Group(list(range(n))), None)


@pytest.mark.parametrize("what", ["chunked", "lora", "heads"])
def test_unported_tp_paths_raise(what):
    """What a tp mesh refuses: head counts that tp does not divide
    (ValueError). The two paths that refused before run: the chunked cross
    entropy over a split lm_head (vocab-parallel; at a one-rank group it is
    the whole tree's loss) and a LoRA view of a split base (a column part:
    this rank's columns of x @ w + (x @ a) @ b, b's columns cut on use).
    Both are held to JAX across ranks in test_torch_tp_lora.py."""
    from flash_vstream_tpu_torch.models.layers import dense, layer_slice, mha
    from flash_vstream_tpu_torch.models.llm import nll_sum_chunked
    from flash_vstream_tpu_torch.parallel.collectives import single_group
    from flash_vstream_tpu_torch.parallel.tensor import TPShard, tp_shard_tree
    from flash_vstream_tpu_torch.train.lora import LoRAWeight
    whole = params_from_numpy(_params(), "cpu")
    params = tp_shard_tree(whole, _fake_tp(8 if what == "heads" else 2))
    h = torch.randn(1, 4, 32, generator=torch.Generator().manual_seed(0))
    if what == "chunked":
        one = dict(whole, lm_head=TPShard(whole["lm_head"], 1, single_group(),
                                          whole["lm_head"].shape, "column"))
        ids = torch.tensor([[3, 77, -100, 120]])
        got = nll_sum_chunked(one, TLLMConfig(**CFG_KW), h, ids, chunk=3,
                              vocab_tile=32)
        want = nll_sum_chunked(whole, TLLMConfig(**CFG_KW), h, ids, chunk=3)
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
        assert got[1] == want[1] == 3
    elif what == "lora":
        w = layer_slice(params["layers"], 0)["attn"]["wq"]["w"]
        w0 = layer_slice(whole["layers"], 0)["attn"]["wq"]["w"]
        g = torch.Generator().manual_seed(1)
        a, b = torch.randn(32, 2, generator=g), torch.randn(2, 32, generator=g)
        got = dense(h, LoRAWeight(w, a, b))
        want = dense(h, LoRAWeight(w0, a, b))[..., :16]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        with pytest.raises(ValueError, match="heads do not split over tp 8"):
            mha(layer_slice(params["layers"], 0)["attn"], h, num_heads=4,
                num_kv_heads=2, head_dim=8)
