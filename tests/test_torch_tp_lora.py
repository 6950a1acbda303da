"""Tensor-parallel LoRA and QLoRA in the port's Trainer (models/layers.py
`_part_matmul`, parallel/tensor.py) and the chunked cross entropy over a
vocab-split head (models/llm.py `_nll_sum_split`), across gloo ranks on the
CPU, against the JAX Trainer and `cross_entropy_loss_chunked` on
create_mesh(dp, tp) over as many of its virtual CPU devices.

The model, the steps and the tolerances of tests/test_torch_tp_train.py:
2 layers, hidden 32, 4 heads and 2 kv heads, with Qwen's q/k/v biases
(split by the rules, so beside a whole quantized base they are gathered
on use); 3 steps of a global batch of
4 with grad_accum 2, clipping and weight decay on; rank-4 adapters (b != 0,
so a has a gradient at step 1) over every projection of the layers. The
bases: f32 ("plain": every projection split as `LLM_RULES` name it), int8
and int4 over every projection and the lm_head (whole on every rank, as
JAX's rules leave `.q`/`.q4`/`.scale`: the layers run whole), and two
mixes of split and quantized bases in one layer ("mix8", "mix4" with
int4 blocks of 8 rows), where the quantized ones are cut on use. Held:
the losses within 1e-5 relative, every adapter leaf after the steps within
5e-4 relative and 5e-5 absolute; every adapter leaf's first-step gradient
equal bit for bit on the ranks of a tp group; each rank's resting base and
adapters as JAX's specs name them (a quantized leaf's fields whole).
The chunked loss: the loss and the gradients of the hidden states and of
the head within 1e-5 relative (1e-6 absolute) of JAX's, with ignored
targets, at tp 2 and 4, untiled and with a vocab tile, over a column
lm_head and a tied vocab-split embed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from flash_vstream_tpu.core.config import LLMConfig
from flash_vstream_tpu.models.llm import (cross_entropy_loss,
                                          cross_entropy_loss_chunked,
                                          decoder_forward, embed_tokens,
                                          init_llm_params, lm_head)
from flash_vstream_tpu.parallel.sharding import create_mesh, param_shardings
from flash_vstream_tpu.train.lora import init_lora_params, lora_views
from flash_vstream_tpu.train.trainer import TrainConfig as JConfig
from flash_vstream_tpu.train.trainer import Trainer as JTrainer
from flash_vstream_tpu.weights.quantize import (quantize_params,
                                                quantize_params4)
from flash_vstream_tpu_torch.parallel.collectives import spawn

CFG_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, attention_bias=True)
CFG = LLMConfig(**CFG_KW)
TKW = dict(learning_rate=1e-2, total_steps=20, grad_accum=2,
           warmup_ratio=0.0, weight_decay=0.01, zero_stage=2)
ALPHA, RANK = 8.0, 4
MIX8 = (r"layers/attn/w[ko]/w$", r"layers/mlp/(up|down)/w$")
MIX4 = (r"layers/attn/w[qvo]/w$", r"layers/mlp/(gate|down)/w$")
# (world, [(tp, bases)]): dp = world / tp
WORLDS = {2: [(2, ["plain", "int8", "int4", "mix8", "mix4"])],
          4: [(4, ["plain", "mix4"]), (2, ["plain", "int8", "int4",
                                            "mix8"])]}
RUNS = [((1, 2), b) for b in WORLDS[2][0][1]] + \
    [((1, 4), b) for b in WORLDS[4][0][1]] + \
    [((2, 2), b) for b in WORLDS[4][1][1]]
MESHES = [(1, 2), (1, 4), (2, 2)]
# the chunked loss: (tied, chunk, vocab_tile)
CE_CASES = [(False, 8, 0), (False, 5, 16), (True, 8, 16)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bases():
    p = init_llm_params(jax.random.PRNGKey(0), CFG)
    return {"plain": _np(p), "int8": _np(quantize_params(p)),
            "int4": _np(quantize_params4(p)),
            "mix8": _np(quantize_params(p, targets=MIX8)),
            "mix4": _np(quantize_params4(p, targets=MIX4, block=8))}


def _lora():
    lora = _np(init_lora_params(jax.random.PRNGKey(1),
                                init_llm_params(jax.random.PRNGKey(0), CFG),
                                rank=RANK))
    rng = np.random.default_rng(2)
    for ab in lora.values():        # b != 0, so a has a gradient
        ab["b"] = (rng.standard_normal(ab["b"].shape) * 0.05).astype(
            np.float32)
    return lora


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        ids = rng.integers(0, 128, size=(2, 4, 16))
        out.append({"ids": ids, "labels": ids})
    return out


def jax_lora_loss(lp, batch, key, base):
    eff = lora_views(base, lp, alpha=ALPHA, rank=RANK)
    ids, labels = batch["ids"], batch["labels"]
    pos = jnp.broadcast_to(jnp.arange(ids.shape[1])[None], ids.shape)
    h, _ = decoder_forward(eff, CFG, embed_tokens(eff, ids), pos)
    return cross_entropy_loss(lm_head(eff, CFG, h), labels)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    bases, lora = _bases(), _lora()
    out = {}
    for world, runs in WORLDS.items():
        d = tmp_path_factory.mktemp(f"lora{world}")
        spawn(torch_ranks.tp_lora_cases, world, str(d), CFG_KW, bases, lora,
              _batches(), runs, TKW, ALPHA, RANK, init_file=str(d / "init"))
        res = [torch.load(d / f"rank{r}.pt", weights_only=False)
               for r in range(world)]
        i = 0
        for tp, names in runs:
            for name in names:
                out[(world // tp, tp), name] = [r[i] for r in res]
                i += 1
    return out


_JAX = {}


def _jax(dp, tp, base):
    """The JAX Trainer's losses and adapters after the steps on
    create_mesh(dp, tp), the base frozen and laid out by its specs."""
    if (dp, tp, base) not in _JAX:
        tr = JTrainer(jax_lora_loss, jax.tree.map(jnp.asarray, _lora()),
                      JConfig(**TKW), mesh=create_mesh(dp=dp, tp=tp),
                      frozen=jax.tree.map(jnp.asarray, _bases()[base]))
        losses = [tr.run_step(jax.tree.map(jnp.asarray, b),
                              jax.random.PRNGKey(s))
                  for s, b in enumerate(_batches())]
        leaves = {jax.tree_util.keystr(p): np.asarray(v)
                  for p, v in jax.tree_util.tree_leaves_with_path(tr.params)}
        _JAX[(dp, tp, base)] = losses, leaves
    return _JAX[(dp, tp, base)]


def _lora_key(path):
    """'layers/attn/wq/w/a' -> JAX's "['layers/attn/wq/w']['a']"."""
    leaf, k = path.rsplit("/", 1)
    return f"['{leaf}']['{k}']"


@pytest.mark.parametrize("mesh,base", RUNS)
def test_lora_matches_jax(ranks, mesh, base):
    dp, tp = mesh
    res = ranks[mesh, base]
    losses, leaves = _jax(dp, tp, base)
    for r in range(dp * tp):
        np.testing.assert_allclose(res[r]["losses"], losses, rtol=1e-5)
    got = res[0]["lora"]
    assert len(got) == 14
    for p, x in got.items():
        np.testing.assert_allclose(x, leaves[_lora_key(p)], rtol=5e-4,
                                   atol=5e-5, err_msg=p)
    moved = [p for p, x in got.items()
             if not np.array_equal(x, _lora()[p.rsplit("/", 1)[0]][
                 p.rsplit("/", 1)[1]])]
    assert len(moved) == 14, moved


@pytest.mark.parametrize("mesh", MESHES)
def test_factor_gradients_equal_over_tp(ranks, mesh):
    """Every adapter leaf rests whole and is cut on use beside a split base;
    its gradient, summed over tp by the copy-to region it enters, is the
    same on every rank of a tp group, bit for bit, so the Trainer reduces
    nothing over tp."""
    dp, tp = mesh
    for (m, base), res in ranks.items():
        if m != mesh:
            continue
        for r in range(dp * tp):
            mine, first = res[r]["grads"], res[r - r % tp]["grads"]
            assert len(mine) == 14
            for p, g in mine.items():
                np.testing.assert_array_equal(g, first[p],
                                              err_msg=f"{base} {p}")


def _specs(tree, dp, tp):
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_leaves_with_path(
                param_shardings(create_mesh(dp=dp, tp=tp), tree))}


def _keystr(path):
    return "".join(f"['{k}']" for k in path.split("/"))


@pytest.mark.parametrize("mesh", MESHES)
def test_resting_layout_as_jax_specs(ranks, mesh):
    """Each rank's resting base: a float leaf split 1/tp on the dim JAX's
    spec names 'tp', a quantized leaf's every field whole (JAX's specs
    name no 'tp' for `.q`, `.q4`, `.scale`); the adapters whole."""
    dp, tp = mesh
    bases = _bases()
    for (m, base), res in ranks.items():
        if m != mesh:
            continue
        specs = _specs(bases[base], dp, tp)
        flat = {jax.tree_util.keystr(p): np.shape(v) for p, v in
                jax.tree_util.tree_leaves_with_path(bases[base])}
        split = quant = 0
        for r in range(dp * tp):
            for p, shape in res[r]["frozen"].items():
                if isinstance(shape, dict):
                    quant += 1
                    for f, s in shape.items():
                        k = _keystr(p) + f".{f}"
                        assert "tp" not in specs[k] and s == flat[k], (p, f)
                    continue
                spec, want = specs[_keystr(p)], list(flat[_keystr(p)])
                for i, a in enumerate(spec):
                    if a == "tp":
                        want[i] //= tp
                        split += 1
                assert tuple(want) == shape, (base, p, shape, spec)
            for p, shape in res[r]["adapters"].items():
                assert shape == np.shape(_lora()[p.rsplit("/", 1)[0]][
                    p.rsplit("/", 1)[1]]), p
        assert split, base
        assert bool(quant) == (base != "plain"), base


def test_mixed_layers_split_and_whole():
    """The mixes put split and quantized bases in one layer, so the
    quantized ones are cut on use (the int4 rows of wo and down in whole
    8-row blocks at tp 4); the all-quantized bases leave each layer's
    projections whole, so those layers run whole on every rank."""
    b = _bases()
    for name, quant in (("mix8", {"wk", "wo", "up", "down"}),
                        ("mix4", {"wq", "wv", "wo", "gate", "down"})):
        layers = b[name]["layers"]
        got = {k for g in ("attn", "mlp") for k, v in layers[g].items()
               if hasattr(v["w"], "_fields")}
        assert got == quant, (name, got)
    assert b["mix4"]["layers"]["mlp"]["down"]["w"].scale.shape == (2, 8, 32)
    for name in ("int8", "int4"):
        layers = b[name]["layers"]
        assert all(hasattr(v["w"], "_fields") for g in ("attn", "mlp")
                   for v in layers[g].values())
        assert hasattr(b[name]["lm_head"], "_fields")


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    rng = np.random.default_rng(5)
    params = _bases()["plain"]
    hidden = rng.standard_normal((2, 12, 32)).astype(np.float32)
    labels = rng.integers(0, 128, size=(2, 12))
    labels[0, 3:6] = -100
    labels[1, -1] = -100
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"ce{world}")
        spawn(torch_ranks.tp_chunked_losses, world, str(d), CFG_KW, params,
              hidden, labels, CE_CASES, init_file=str(d / "init"))
        out[world] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return params, hidden, labels, out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", range(len(CE_CASES)))
def test_chunked_loss_over_split_head_matches_jax(chunked, tp, case):
    """The vocab-parallel chunked loss (max and sum over tp, the target's
    logit from the rank that holds it, ignored targets left out) against
    JAX's `cross_entropy_loss_chunked` with the head laid out on
    create_mesh(1, tp): the loss and both gradients, on every rank."""
    params, hidden, labels, out = chunked
    tied, chunk, tile = CE_CASES[case]
    cfg = LLMConfig(**CFG_KW, tie_word_embeddings=tied)
    p = {k: v for k, v in params.items() if not (tied and k == "lm_head")}
    mesh = create_mesh(dp=1, tp=tp)
    p = jax.device_put(jax.tree.map(jnp.asarray, p),
                       param_shardings(mesh, p))
    head = "embed" if tied else "lm_head"
    assert "tp" in tuple(p[head].sharding.spec)

    def loss(h, w):
        return cross_entropy_loss_chunked({**p, head: w}, cfg, h,
                                          jnp.asarray(labels), chunk=chunk,
                                          vocab_tile=tile)
    want, (gh, gw) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(hidden), p[head])
    for r in range(tp):
        got = out[tp][r][case]
        np.testing.assert_allclose(got["loss"], float(want), rtol=1e-5)
        np.testing.assert_allclose(got["gh"], np.asarray(gh), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["gw"], np.asarray(gw), rtol=1e-5,
                                   atol=1e-6)
