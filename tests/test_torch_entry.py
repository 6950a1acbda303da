"""The port's driver entry points (flash_vstream_tpu_torch/entry.py) against
JAX's (__graft_entry__.py) on the CPU: `entry(cfg=tiny)` against JAX's
forward built from the same public functions (encode_video, embed_tokens,
decoder_forward, lm_head) on the same f32 weights, patches, ids and k-means
draws; and `dryrun_multichip(2)` in gloo ranks, its printed losses against
JAX's `dryrun_multichip(2)` on a two-device virtual mesh. Tolerances are
stated per test."""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_vstream_tpu.core.config import tiny_qwen_config as jtiny
from flash_vstream_tpu.models.llm import (decoder_forward as jdecoder,
                                          embed_tokens as jembed,
                                          lm_head as jhead)
from flash_vstream_tpu.models.vstream_qwen import (
    build_qwen_positions as jpositions, encode_video as jencode,
    init_qwen_params as jinit)
from flash_vstream_tpu_torch import entry as tentry
from flash_vstream_tpu_torch.core.config import tiny_qwen_config
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY_TOL = 1e-4       # f32 logits, of their max |value|


def _jax_entry_fn(cfg):
    """__graft_entry__.entry's forward at `cfg`, from JAX's public
    functions (the JAX entry builds its config inside itself)."""
    t, gh, gw = grid = tentry.ENTRY_GRID
    dam = min(t, cfg.flash_memory.dam_grid_len) * gh * gw // 4
    csm = min(t, cfg.flash_memory.csm_grid_len) * (gh // 2) * (gw // 2) // 4
    n_vis = dam + csm
    S = 32 + n_vis + 32

    def fn(params, patches, input_ids, key):
        vis = jencode(params, cfg, patches, grid, key=key)
        embeds = jembed(params["llm"], input_ids)
        embeds = jnp.concatenate([
            embeds[:, :16], vis.video_embeds[None].astype(embeds.dtype),
            embeds[:, 16 + n_vis:]], axis=1)
        positions, _ = jpositions(S, 16, n_vis, vis.visual_positions)
        h, _ = jdecoder(params["llm"], cfg.llm, embeds, positions)
        return jhead(params["llm"], cfg.llm, h)
    return fn


def test_entry_config_is_jax_entry_config(monkeypatch):
    """entry_config() equals, field for field, the config JAX's entry()
    builds inside itself (caught at its init_qwen_params call, before any
    weight is drawn)."""
    import __graft_entry__
    from flash_vstream_tpu.models import vstream_qwen as jvq
    seen = {}

    class Caught(Exception):
        pass

    def catch(key, cfg, dtype=None):
        seen["cfg"] = cfg
        raise Caught

    monkeypatch.setattr(jvq, "init_qwen_params", catch)
    with pytest.raises(Caught):
        __graft_entry__.entry()
    assert dataclasses.asdict(tentry.entry_config()) == dataclasses.asdict(
        seen["cfg"])


def test_entry_matches_jax():
    """entry(cfg=tiny, device="cpu") against JAX's forward: the patches and
    ids are the same numpy draws, the weights JAX's (carried across), the
    k-means draws JAX's uniform(PRNGKey(0)); the tiny memory budgets (CSM 4,
    DAM 2 grid frames) are below the 8 temporal patches, so the k-means and
    the retrieval run. Logits within ENTRY_TOL of their max."""
    fn, (params, patches, ids, draws) = tentry.entry(tiny_qwen_config(),
                                                     device="cpu")
    assert params["llm"]["embed"].dtype == torch.bfloat16
    jcfg = jtiny()
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    t, gh, gw = tentry.ENTRY_GRID
    jpatches = rng.normal(size=(t * gh * gw, patches.shape[1])).astype(
        np.float32)
    jids = rng.integers(0, jcfg.llm.vocab_size, size=ids.shape)
    np.testing.assert_array_equal(patches.numpy(), jpatches)
    np.testing.assert_array_equal(ids.numpy(), jids)
    want = np.asarray(jax.jit(_jax_entry_fn(jcfg))(
        jparams, jnp.asarray(jpatches), jnp.asarray(jids),
        jax.random.PRNGKey(0)))

    def jax_draws(n):
        return torch.from_numpy(np.array(
            jax.random.uniform(jax.random.PRNGKey(0), (n,))))

    got = fn(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
             patches, ids, jax_draws)
    assert got.shape == want.shape == (1, ids.shape[1], 512)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=ENTRY_TOL * scale)
    # the default draws (torch's, seeded) also give finite logits
    assert torch.isfinite(fn(params, patches, ids, draws).float()).all()


def test_entry_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.entry(tiny_qwen_config())


def _jax_inputs(n_devices):
    """JAX's dryrun_multichip weights (its keys 0, 1, 2, 3, 7) as numpy
    trees, and its memory draws: micro-batch i of a step keyed k takes
    split(k)[1] after i splits (its Trainer's scan), sample b of it
    split(that, B)[b], whose uniforms the Flash and STAR memories draw."""
    from flash_vstream_tpu.core.config import LLMConfig as JLLMConfig
    from flash_vstream_tpu.core.config import tiny_llava_config as jllava
    from flash_vstream_tpu.models.llm import init_llm_params
    from flash_vstream_tpu.models.vstream_llava import init_llava_params
    from flash_vstream_tpu.train.lora import (QWEN_TARGETS,
                                              init_lora_params)
    from flash_vstream_tpu.weights.quantize import quantize_params

    def np_tree(t):
        return jax.tree.map(np.asarray, t)
    qwen = jinit(jax.random.PRNGKey(1), jtiny())
    inputs = {
        "llava": np_tree(init_llava_params(jax.random.PRNGKey(0), jllava())),
        "qwen": np_tree(qwen),
        "qwen_lora": np_tree(init_lora_params(
            jax.random.PRNGKey(2), quantize_params(qwen), rank=4,
            targets=QWEN_TARGETS)),
        "pp": np_tree(init_llm_params(jax.random.PRNGKey(3), JLLMConfig(
            **tentry.PP_CFG))),
        "serve": np_tree(jinit(jax.random.PRNGKey(7), jtiny())),
    }
    B = n_devices // 2                   # the dp rows of its dp x tp 2 mesh
    draws = {}
    for section, step_key in (("llava", 0), ("qwen", 1)):
        key = jax.random.PRNGKey(step_key)
        for micro in range(2):
            key, sub = jax.random.split(key)
            for b, kb in enumerate(jax.random.split(sub, B)):
                draws[(section, micro, b)] = {
                    n: np.asarray(jax.random.uniform(kb, (n,)))
                    for n in range(1, 65)}
    inputs["draws"] = draws
    return inputs


_NUMBERS = re.compile(r"llava-loss=([\d.]+) qwen-qlora-loss=([\d.]+) "
                      r"tp(\d+)-decode=(\d+)tok pp(\d+)x dp(\d+) "
                      r"28L-loss=([\d.]+) sp(\d+)x dp(\d+) 28L-loss=([\d.]+)")


def _qwen_micro_losses(inputs, monkeypatch):
    """The QLoRA section's two micro-batch losses (its data, JAX's keys and
    draws) through JAX's composition and the port's, one sample each, and
    for each micro-batch the DAM frames both retrieved and, where they
    differ, the port's distances from that slot's query to either frame."""
    from flash_vstream_tpu.models.vstream_qwen import visual_token_count
    from flash_vstream_tpu.train.lora import lora_views as jviews
    from flash_vstream_tpu.weights.quantize import quantize_params as jquant
    from flash_vstream_tpu_torch.core.config import tiny_llava_config
    from flash_vstream_tpu_torch.models import flash_memory as tfm
    from flash_vstream_tpu_torch.models import llm as tllm
    from flash_vstream_tpu_torch.models import vstream_qwen as tvq
    from flash_vstream_tpu_torch.models.vstream_llava import (
        star_valid_counts)
    from flash_vstream_tpu_torch.train.lora import lora_views
    from flash_vstream_tpu_torch.weights.from_jax import lora_from_numpy
    from flash_vstream_tpu_torch.weights.quantize import quantize_params
    cfg, tcfg = jtiny(), tiny_qwen_config()
    jbase = jquant(jax.tree.map(jnp.asarray, inputs["qwen"]))
    jeff = jviews(jbase, jax.tree.map(jnp.asarray, inputs["qwen_lora"]),
                  alpha=8.0, rank=4)
    teff = lora_views(quantize_params(params_from_numpy(inputs["qwen"],
                                                        "cpu")),
                      lora_from_numpy(inputs["qwen_lora"], "cpu"),
                      alpha=8.0, rank=4)
    rng = np.random.default_rng(0)       # the dryrun's data, in its order
    lc, T = tiny_llava_config(), 4
    side = lc.vit.image_size
    rng.normal(size=(2, 1, T, 3, side, side))
    rng.integers(1, 200, size=(2, 1, 24))
    rng.integers(1, 200, size=(2, 1, 23 + sum(star_valid_counts(lc, T))))
    grid = (6, 8, 8)
    n_dam, n_csm = visual_token_count(cfg, *grid)
    n_vis = n_dam + n_csm
    SQ = 8 + n_vis + 8
    P = rng.normal(size=(2, 1, 384, 1176)).astype(np.float32)
    ids = rng.integers(1, 200, size=(2, 1, SQ))
    labels = rng.integers(1, 200, size=(2, 1, SQ))
    seen = {}
    real = tfm.dam_retrieve

    def dam_retrieve(tem_x, tem_weights, small_bank, *a):
        idx, top = real(tem_x, tem_weights, small_bank, *a)
        seen["q"] = tem_x[top].flatten(1).float()
        seen["bank"] = small_bank.flatten(1).float()
        return idx, top
    monkeypatch.setattr(tfm, "dam_retrieve", dam_retrieve)
    out = []
    for micro in range(2):
        draws = inputs["draws"][("qwen", micro, 0)]
        key_draws = jnp.asarray(draws[grid[0]])
        p, i, lab = P[micro, 0], ids[micro, 0], labels[micro, 0]
        jv = jencode(jeff, cfg, jnp.asarray(p), grid,
                     key=_key_with(key_draws, micro))
        pos, _ = jpositions(SQ, 8, n_vis, jv.visual_positions)
        e = jembed(jeff["llm"], jnp.asarray(i)[None])
        e = jnp.concatenate([e[:, :8], jv.video_embeds[None].astype(e.dtype),
                             e[:, 8 + n_vis:]], 1)
        h, _ = jdecoder(jeff["llm"], cfg.llm, e, pos)
        from flash_vstream_tpu.models.llm import cross_entropy_loss as jce
        jloss = float(jce(jhead(jeff["llm"], cfg.llm, h),
                          jnp.asarray(lab)[None]))
        tv = tvq.encode_video(
            teff, tcfg, torch.from_numpy(p), grid,
            draws=lambda n: torch.from_numpy(np.array(draws[n])))
        tpos, _ = tvq.build_qwen_positions(SQ, 8, n_vis, tv.visual_positions)
        te = tllm.embed_tokens(teff["llm"], torch.from_numpy(i)[None])
        te = torch.cat([te[:, :8], tv.video_embeds[None].to(te.dtype),
                        te[:, 8 + n_vis:]], 1)
        th = tllm.decoder_forward(teff["llm"], tcfg.llm, te, tpos)
        tloss = float(tllm.cross_entropy_loss(
            tllm.lm_head(teff["llm"], tcfg.llm, th),
            torch.from_numpy(lab)[None]))
        jf = np.asarray(jv.visual_positions)[0, :n_dam:16]
        tf = tv.visual_positions.numpy()[0, :n_dam:16]
        d = ((seen["bank"][None] - seen["q"][:, None]) ** 2).sum(-1)
        out.append(dict(jax=jloss, port=tloss, jax_frames=jf, port_frames=tf,
                        csm_equal=np.array_equal(
                            np.asarray(jv.visual_positions)[:, n_dam:],
                            tv.visual_positions.numpy()[:, n_dam:]),
                        dist=d.numpy()))
    return out


def _key_with(uniforms, micro):
    """JAX's own key for the micro-batch (the draws table was made from
    it; here it is rebuilt as test_torch_entry._jax_inputs splits it)."""
    key = jax.random.PRNGKey(1)
    for _ in range(micro + 1):
        key, sub = jax.random.split(key)
    kb = jax.random.split(sub, 1)[0]
    assert np.array_equal(np.asarray(jax.random.uniform(kb, uniforms.shape)),
                          np.asarray(uniforms))
    return kb


def test_dryrun_multichip_matches_jax(capfd, monkeypatch):
    """dryrun_multichip(2) over two gloo ranks with JAX's weights and
    memory draws carried in, against JAX's dryrun_multichip(2) on its
    two-device virtual CPU mesh (a fresh interpreter): the printed LLaVA,
    pp and sp losses (4 decimals) within 2e-4, the same decode length,
    pp/sp widths and serve summary. The QLoRA loss: each side's printed
    value is the mean of its own composition's two micro-batch losses
    (within 2e-4), and the two compositions agree within 1e-4 relative on
    a micro-batch unless its DAM retrieval parts at a tie: the CSM equal,
    and in each slot where the frames differ the port's query as near to
    JAX's frame as to its own (1e-4 relative), a two-frame cluster midway
    between its frames (tests/flash_ties.py). Without `inputs` the ranks
    draw their own and every section still passes its checks."""
    import __graft_entry__
    __graft_entry__.dryrun_multichip(2)
    jline = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip(2)")][-1]
    inputs = _jax_inputs(2)
    res = tentry.dryrun_multichip(2, inputs)
    line = [ln for ln in capfd.readouterr().out.splitlines()
            if ln.startswith("dryrun_multichip(2)")][-1]
    want = _NUMBERS.search(jline).groups()
    got = _NUMBERS.search(line).groups()
    for i in (0, 6, 9):
        assert abs(float(got[i]) - float(want[i])) <= 2e-4, (line, jline)
    assert [got[i] for i in (2, 3, 4, 5, 7, 8)] == [
        want[i] for i in (2, 3, 4, 5, 7, 8)]
    assert line.split("28L-loss=")[-1].split(" ", 1)[1] == \
        jline.split("28L-loss=")[-1].split(" ", 1)[1]
    assert res["mesh"] == {"dp": 1, "tp": 2}
    micros = _qwen_micro_losses(inputs, monkeypatch)
    assert abs(np.mean([m["port"] for m in micros]) - res["qwen"]) <= 2e-4
    assert abs(np.mean([m["jax"] for m in micros]) - float(want[1])) <= 2e-4
    for m in micros:
        if abs(m["port"] - m["jax"]) <= 1e-4 * abs(m["jax"]):
            continue
        assert m["csm_equal"]
        for slot in np.nonzero(m["jax_frames"] != m["port_frames"])[0]:
            d = m["dist"][slot]
            a, b = d[m["jax_frames"][slot]], d[m["port_frames"][slot]]
            assert abs(a - b) <= 1e-4 * max(a, b), (slot, a, b)
    own = tentry.dryrun_multichip(2)
    assert all(np.isfinite(own[k]) for k in ("llava", "qwen", "pp", "sp"))
