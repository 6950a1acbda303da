"""The port's disaggregated streaming session (parallel/serve.py,
QwenStreamSession(placement=...)) on three CPU entries, ["cpu"] * 3, held
against the port's one-device session and JAX's disaggregated session on
its three virtual CPU devices: the four cases of the JAX package's
tests/test_disaggregated_serve.py.

The port's placed and one-device sessions ingest with the same code on
the same device, so their snapshots are equal bit for bit and their
answers the same ids. JAX's snapshots agree with the port's to bf16
rounding only (tests/test_torch_streaming.py), so the port answers JAX's
snapshot when the two packages are compared.
"""
import threading

import numpy as np
import pytest
import torch

import jax

from flash_vstream_tpu.core.config import tiny_qwen_config as jtiny
from flash_vstream_tpu.models.vstream_qwen import init_qwen_params
from flash_vstream_tpu.parallel.serve import (
    make_serve_placement as jplacement)
from flash_vstream_tpu.parallel.serve import (
    place_qwen_serve_params as jplace)
from flash_vstream_tpu.preprocess.qwen_processor import (
    make_byte_qwen_tokenizer as jtok)
from flash_vstream_tpu.runtime.generation import GenerationConfig as JGen
from flash_vstream_tpu.runtime.streaming import QwenStreamSession as JSession

from flash_vstream_tpu_torch.core.config import tiny_qwen_config
from flash_vstream_tpu_torch.models.vstream_qwen import VStreamQwen
from flash_vstream_tpu_torch.parallel.inference import TPDecoder
from flash_vstream_tpu_torch.parallel.serve import (make_serve_placement,
                                                     place_qwen_serve_params)
from flash_vstream_tpu_torch.preprocess.qwen_processor import (
    make_byte_qwen_tokenizer)
from flash_vstream_tpu_torch.runtime.generation import GenerationConfig
from flash_vstream_tpu_torch.runtime.streaming import QwenStreamSession
from flash_vstream_tpu_torch.weights.from_jax import params_from_numpy

torch.set_num_threads(1)

KW = dict(frame_hw=(56, 56), clip_size=2, bank_size=32, max_len=512)
Q = "Describe the scene."
CPU3 = ["cpu"] * 3


@pytest.fixture(scope="module")
def setup():
    """JAX's tree (PRNGKey(7), as the JAX test) and the port's model over
    the same numbers."""
    jparams = init_qwen_params(jax.random.PRNGKey(7), jtiny())
    model = VStreamQwen(tiny_qwen_config(), params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"))
    return jparams, model


def _scores(step, n):
    """The JAX session's k-means init draws of ingest `step`."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(step), (n,))))


def _mk(model, placement):
    s = QwenStreamSession(model, make_byte_qwen_tokenizer(),
                          placement=placement, **KW)
    s._init_scores = _scores
    return s


def _to_torch(jsnap, like):
    return tuple(torch.from_numpy(np.asarray(x, np.float32)
                                  if x.dtype == jax.numpy.bfloat16
                                  else np.array(x)).to(y.dtype)
                 for x, y in zip(jsnap, like))


def test_placement_split(setup):
    """The ingest side is the whole vision tower and nothing of the
    decoder; the decode side holds the merger and the decoder's shards,
    one a decode device, each leaf shaped as JAX's shard of it on its
    virtual devices."""
    jparams, model = setup
    pl = make_serve_placement(n_ingest=1, n_decode=2, devices=CPU3)
    assert pl.decode_mesh.shape == {"dp": 1, "tp": 2}
    ingest, decode = place_qwen_serve_params(model, pl)
    assert set(ingest) == {"vit"} and set(decode) == {"vit", "llm"}
    vit_keys = set(ingest["vit"].state_dict())
    assert vit_keys == set(model.vit.state_dict())
    assert not any(k.split(".")[0] in ("embed", "lm_head", "final_norm")
                   for k in vit_keys)
    assert all(p.device == pl.ingest_device
               for p in ingest["vit"].parameters())
    assert set(decode["vit"]) == {"merger"}
    for k, v in model.vit.merger.state_dict().items():
        assert torch.equal(decode["vit"]["merger"].state_dict()[k], v)
    llm = decode["llm"]
    assert isinstance(llm, TPDecoder) and len(llm.shards) == 2
    assert llm.group.devices == list(pl.decode_mesh.devices[0])
    # JAX: the same split on its devices 1 and 2, the same shard shapes
    jpl = jplacement(n_ingest=1, n_decode=2)
    jin, jdec = jplace(jparams, jpl)
    assert set(jin) == set(ingest) and set(jdec["vit"]) == {"merger"}
    flat, _ = jax.tree_util.tree_flatten_with_path(jdec["llm"])
    for path, leaf in flat:
        node = llm.shards[0]
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.addressable_shards[0].data.shape, \
            path


def test_disaggregated_answers_match_single_chip(setup, rng):
    """The placed session's snapshots equal the one-device session's bit
    for bit, and its answers and streamed deltas are the same; on JAX's
    snapshot it answers JAX's disaggregated session's text and deltas."""
    jparams, model = setup
    pl = make_serve_placement(n_ingest=1, n_decode=2, devices=CPU3)
    dis, ref = _mk(model, pl), _mk(model, None)
    jdis = JSession(jparams, jtiny(), jtok(), placement=jplacement(1, 2),
                    **KW)
    frames = [rng.integers(0, 255, (56, 56, 3), np.uint8) for _ in range(6)]
    for s in (dis, ref, jdis):
        for i in range(0, 6, 2):
            s.ingest_frames(frames[i:i + 2])
        s.block_until_ingested()
    assert dis.state.tem_x.device == pl.ingest_device
    for a, b in zip(dis._published[0], ref._published[0]):
        assert torch.equal(a, b)
    gen = GenerationConfig(max_new_tokens=6)
    jgen = JGen(max_new_tokens=6, eos_token_ids=())
    assert dis.answer(Q, gen) == ref.answer(Q, gen)
    assert list(dis.answer_stream(Q, gen)) == list(ref.answer_stream(Q, gen))
    jsnap, jn = jdis._published
    assert jn == dis.n_frames
    snap = _to_torch(jax.tree.map(np.asarray, jsnap), dis._published[0])
    assert dis.answer_snapshot(snap, jn, Q, gen) == jdis.answer(Q, jgen)
    c = dis.clone_fresh()
    c._published = (snap, jn)
    assert list(c.answer_stream(Q, gen)) == list(jdis.answer_stream(Q, jgen))


def test_answer_concurrent_with_ingest(setup, rng):
    """An answer on a captured snapshot runs on another thread while four
    more clips ingest: it equals the answer before them, the stream goes
    on, and the snapshot is unchanged (its tensors share no storage with
    the banks that ingest writes in place: the handover on one device
    moves nothing)."""
    _, model = setup
    pl = make_serve_placement(n_ingest=1, n_decode=2, devices=CPU3)
    sess = _mk(model, pl)
    frames = [rng.integers(0, 255, (56, 56, 3), np.uint8) for _ in range(12)]
    gen = GenerationConfig(max_new_tokens=4)
    sess.ingest_frames(frames[:2])
    sess.ingest_frames(frames[2:4])
    sess.block_until_ingested()
    snap, nf = sess._published
    before = [x.clone() for x in snap]
    written = {sess.state.bank.untyped_storage().data_ptr(),
               sess.state.bank_small.untyped_storage().data_ptr(),
               sess.state.bank_pos.untyped_storage().data_ptr()}
    assert not written & {x.untyped_storage().data_ptr() for x in snap}
    baseline = sess.answer_snapshot(snap, nf, "Now?", gen)

    out = {}
    th = threading.Thread(target=lambda: out.setdefault(
        "a", sess.answer_snapshot(snap, nf, "Now?", gen)))
    th.start()
    for i in range(4, 12, 2):
        sess.ingest_frames(frames[i:i + 2])
    sess.block_until_ingested()
    th.join(timeout=300)
    assert not th.is_alive()
    assert out["a"] == baseline
    assert sess.n_frames == 6          # 12 frames = 6 temporal pairs
    assert all(torch.equal(a, b) for a, b in zip(snap, before))


def test_session_reset_and_save_load_keep_placement(setup, rng, tmp_path):
    """reset, save_session / load_session and clone_fresh keep the
    placement: the state on the ingest device, the same decoder, and the
    loaded stream answers as before."""
    _, model = setup
    pl = make_serve_placement(n_ingest=1, n_decode=2, devices=CPU3)
    sess = _mk(model, pl)
    frames = [rng.integers(0, 255, (56, 56, 3), np.uint8) for _ in range(4)]
    sess.ingest_frames(frames[:2])
    sess.ingest_frames(frames[2:])
    sess.block_until_ingested()
    gen = GenerationConfig(max_new_tokens=4)
    want = sess.answer(Q, gen)
    p = sess.save_session(str(tmp_path / "sess"))
    sess.reset()
    assert sess.state.tem_x.device == pl.ingest_device and sess.n_frames == 0
    sess.load_session(p)
    assert sess.state.tem_x.device == pl.ingest_device
    assert sess.n_frames == 2 and sess.placement is pl
    assert sess.answer(Q, gen) == want
    c = sess.clone_fresh()
    assert c.placement is pl and c.llm is sess.llm and c.n_frames == 0


def test_placement_needs_devices():
    """JAX's asserts, raised as errors: an ingest device and at least one
    decode device, and no more than the devices given."""
    with pytest.raises(ValueError, match="needs >= 2 devices"):
        make_serve_placement(devices=["cpu"])
    with pytest.raises(ValueError):
        make_serve_placement(n_ingest=1, n_decode=3, devices=CPU3)
    with pytest.raises(ValueError):
        make_serve_placement(n_ingest=0, devices=CPU3)
    pl = make_serve_placement(n_ingest=2, devices=["cpu"] * 4)
    assert pl.decode_mesh.shape == {"dp": 1, "tp": 2}
