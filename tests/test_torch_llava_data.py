"""The LLaVA family's training data pipeline of the port against JAX's
(flash_vstream_tpu/train/data.py), array for array: every preprocess
template with the byte tokenizer and the Llama fixture of tests/hf_tok.py,
the collators (fixed and batch-derived lengths), the spliced labels and
segments, the length-grouped order, breakpoint slicing, the frame-sampling
rule and each dataset branch (features from `.npy` and `.safetensors`,
JAX's JPEG frame directories, a single image, text, the resample of a
corrupt item); `.npy` frame directories equal the JPEG directories they
were decoded from. A pre segment padded on the wrong side is shown to
break the equality."""
import json
import os

import numpy as np
import pytest

from flash_vstream_tpu.preprocess.tokenizer import ByteTokenizer as JByte
from flash_vstream_tpu.preprocess import video as jvideo
from flash_vstream_tpu.train import data as jdata
from flash_vstream_tpu.train import train as jtrain
from flash_vstream_tpu_torch.preprocess import video as tvideo
from flash_vstream_tpu_torch.preprocess.tokenizer import ByteTokenizer
from flash_vstream_tpu_torch.train import data as tdata
from flash_vstream_tpu_torch.train import train as ttrain

CONVS = [
    [{"from": "human", "value": "<image>\nWhat is shown?"},
     {"from": "gpt", "value": "A red car."}],
    [{"from": "human", "value": "<image>\nWhat is shown?"},
     {"from": "gpt", "value": "A red car."},
     {"from": "human", "value": "And then?"},
     {"from": "gpt", "value": "It drives away, fast."}],
    # a leading assistant turn is dropped
    [{"from": "gpt", "value": "Hello."},
     {"from": "human", "value": "<image>\nDescribe."},
     {"from": "gpt", "value": "Noise."}],
]
TEXT_CONV = [{"from": "human", "value": "Say two."},
             {"from": "gpt", "value": "Two."}]


def _tokenizers():
    from hf_tok import make_hf_llama_tokenizer
    hf = make_hf_llama_tokenizer()
    return [(JByte(), ByteTokenizer()), (hf, hf)]


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("version", ["v1", "llama_2", "mpt"])
def test_preprocess_templates_match_jax(version):
    """Each template's ids and labels equal JAX's, with and without an
    image, for both tokenizers; every template supervises something."""
    for jtok, ttok in _tokenizers():
        for conv in CONVS + [TEXT_CONV]:
            has_image = conv is not TEXT_CONV
            want = jdata.PREPROCESS_BY_VERSION[version](conv, jtok,
                                                        has_image=has_image)
            got = tdata.PREPROCESS_BY_VERSION[version](conv, ttok,
                                                       has_image=has_image)
            _same(got, want)
            assert (got[1] != -100).any()


def test_preprocess_plain_matches_jax():
    for jtok, ttok in _tokenizers():
        for conv in (CONVS[0], CONVS[2][1:]):
            _same(tdata.preprocess_plain(conv, ttok),
                  jdata.preprocess_plain(conv, jtok))
    with pytest.raises(ValueError):
        tdata.preprocess_plain(CONVS[1], ByteTokenizer())


def _samples(n, rng, media="features"):
    tok = ByteTokenizer()
    out = []
    for i in range(n):
        conv = [{"from": "human",
                 "value": "<image>\n" + "Why is that? " * (1 + 3 * i)},
                {"from": "gpt", "value": f"Because {i}. " * (1 + 2 * i)}]
        ids, labels = tdata.preprocess_v1(conv, tok)
        s = {"input_ids": ids, "labels": labels}
        if media == "features":
            s["features"] = rng.normal(size=(3 + i, 4, 8)).astype(np.float32)
            s["n_frames"] = 3 + i
        elif media == "frames":
            s["frames"] = [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                           for _ in range(2 + i)]
            s["n_frames"] = 2 + i
        else:
            s["image_frame"] = rng.integers(0, 256, (8, 8, 3),
                                            dtype=np.uint8)
        out.append(s)
    return out


@pytest.mark.parametrize("media", ["features", "frames", "image"])
@pytest.mark.parametrize("fixed", [False, True])
def test_collate_splice_match_jax(media, fixed):
    """collate_llava (batch-derived or fixed pre/post lengths: the long
    sample's pre segment is cut from the left, its post from the right;
    videos of 2-6 frames in a bucket of 6), spliced_labels and
    spliced_segments equal JAX's."""
    rng = np.random.default_rng(0)
    samples = _samples(4, rng, media)
    kw = dict(fixed_pre_len=40, fixed_post_len=30) if fixed else {}
    want = jdata.collate_llava(samples, 6, 258, max_text_len=512, **kw)
    got = tdata.collate_llava(samples, 6, 258, max_text_len=512, **kw)
    _same(got, want)
    for n_mem in (0, 7):
        _same(tdata.spliced_labels(got, n_mem),
              jdata.spliced_labels(want, n_mem))
        _same(tdata.spliced_segments(got, n_mem, 258),
              jdata.spliced_segments(want, n_mem, 258))


def test_pre_segment_padded_on_the_wrong_side_fails():
    """The planted fault: the same batch with each pre segment padded on
    the right (its tokens moved away from the image slot) no longer equals
    JAX's."""
    rng = np.random.default_rng(0)
    samples = _samples(3, rng)
    kw = dict(fixed_pre_len=400, fixed_post_len=30)
    want = jdata.collate_llava(samples, 6, 258, **kw)
    got = tdata.collate_llava(samples, 6, 258, **kw)
    _same(got, want)
    ids = got["input_ids"].copy()
    for b in range(ids.shape[0]):
        pre = ids[b, :400]
        real = pre[pre != 258]
        assert len(real) < 400                   # the segment is padded
        ids[b, :400] = 258
        ids[b, :len(real)] = real
    with pytest.raises(AssertionError):
        _same(dict(got, input_ids=ids), want)


def test_collate_text_and_order_match_jax():
    """collate_text at a length that cuts the longest sample and one that
    pads; length_grouped_indices over mixed signed lengths at several
    batch and world sizes and seeds; proportional_schedule."""
    tok = ByteTokenizer()
    samples = []
    for i in range(3):
        ids, labels = tdata.preprocess_v1(
            [{"from": "human", "value": "Count " * (1 + 5 * i)},
             {"from": "gpt", "value": "ok " * (1 + i)}], tok,
            has_image=False)
        samples.append({"input_ids": ids, "labels": labels})
    for n in (40, 256):
        _same(tdata.collate_text(samples, 258, n),
              jdata.collate_text(samples, 258, n))
    lengths = list(np.random.default_rng(1).integers(-30, 30, 37))
    for bs, world, seed in ((1, 1, 0), (4, 1, 3), (2, 8, 0), (3, 2, 7)):
        assert tdata.length_grouped_indices(lengths, bs, world, seed) == \
            jdata.length_grouped_indices(lengths, bs, world, seed)
    sizes = {"video": 9, "image": 2, "text": 3}
    assert tdata.proportional_schedule(sizes, 30) == \
        jdata.proportional_schedule(sizes, 30)


def test_breakpoint_and_sampling_rules_match_jax():
    feats = np.arange(200)[:, None].repeat(3, 1).astype(np.float32)
    for item in ({"time": 50}, {"time": 4}, {"time": 195},
                 {"time": 50, "time_9": 1},
                 {"time": 50, "time_9dense": 400},
                 {"time_9dense": 400}, {}):
        _same(tdata.breakpoint_slice_features(feats, item),
              jdata.breakpoint_slice_features(feats, item))
    for n, m, kind in ((10, 4, "center"), (10, 4, "uniform"),
                       (23, 7, "uniform"), (4, 10, ""), (30, 4, ""),
                       (18001, 50, "")):
        assert tdata.sample_type_indices(n, m, kind) == \
            jdata.sample_type_indices(n, m, kind)


def _write_items(root, items):
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(items, f)
    return path


def test_dataset_feature_branches_match_jax(tmp_path):
    """Features from `.npy` and from `.safetensors` (written by the port's
    writer, read by JAX through `safetensors`), a breakpoint 'time' item,
    the subsample past video_max_frames, and a missing feature file (and,
    under the plain template, a multi-turn item) that resamples another
    item: every sample equal to JAX's, for the v1 and plain templates;
    modality_lengths equal."""
    from flash_vstream_tpu_torch.weights.safetensors_io import save_file
    import torch
    root = str(tmp_path)
    fdir = os.path.join(root, "feats")
    os.makedirs(fdir)
    rng = np.random.default_rng(0)
    np.save(os.path.join(fdir, "a.npy"),
            rng.normal(size=(70, 4, 8)).astype(np.float32))
    save_file({"feature": torch.from_numpy(
        rng.normal(size=(40, 4, 8)).astype(np.float16))},
        os.path.join(fdir, "b.safetensors"))
    items = [{"id": 0, "video": "a", "conversations": CONVS[0]},
             {"id": 1, "video": "b", "time": 20,
              "conversations": CONVS[1]},
             {"id": 2, "video": "missing", "conversations": CONVS[0]},
             {"id": 3, "conversations": TEXT_CONV}]
    path = _write_items(root, items)
    for version in ("v1", "plain"):
        kw = dict(data_path=path, feature_dir=fdir, video_max_frames=50,
                  conv_version=version)
        want_ds = jdata.SupervisedVideoDataset(jdata.DataConfig(**kw),
                                               JByte())
        got_ds = tdata.SupervisedVideoDataset(tdata.DataConfig(**kw),
                                              ByteTokenizer())
        for i in range(3 if version == "plain" else 4):
            want, got = want_ds[i], got_ds[i]
            _same({k: v for k, v in got.items() if k != "id"},
                  {k: v for k, v in want.items() if k != "id"})
            assert got["id"] == want["id"]
        assert got_ds.modality_lengths() == want_ds.modality_lengths()
        if version == "v1":
            assert got_ds[0]["features"].shape == (50, 4, 8)
            assert got_ds[1]["n_frames"] == 30       # the [5, 35) window


def test_dataset_raw_branches_match_jax(tmp_path):
    """JAX's raw-media dry-run dataset (JPEG frame directories, JPEG
    images, text items) read by both datasets: frames, images and ids
    equal; with `video_sample_type` 'uniform' too. The port's own raw
    dataset (`.npy`) holds JAX's pixel draws before their JPEG coding."""
    data_path, media = jtrain.build_synthetic_raw_dataset(
        str(tmp_path / "jpeg"), n_frames=5, side=56)
    for sample_type in ("", "uniform"):
        kw = dict(data_path=data_path, video_dir=media, video_max_frames=3,
                  image_size=56, video_sample_type=sample_type)
        want_ds = jdata.SupervisedVideoDataset(jdata.DataConfig(**kw),
                                               JByte())
        got_ds = tdata.SupervisedVideoDataset(tdata.DataConfig(**kw),
                                              ByteTokenizer())
        for i in range(len(want_ds)):
            want, got = want_ds[i], got_ds[i]
            if "frames" in want:
                want = dict(want, frames=np.stack(want["frames"]))
                got = dict(got, frames=np.stack(got["frames"]))
            _same(got, want)
    npy_path, npy_media = ttrain.build_synthetic_raw_dataset(
        str(tmp_path / "npy"), n_frames=5, side=56)
    rng = np.random.default_rng(0)
    first = rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.load(os.path.join(npy_media, "v0", "000000.npy")), first)
    assert json.load(open(npy_path))[4]["image"] == "img0.npy"


def test_npy_frame_directories(tmp_path):
    """A JPEG frame directory and the `.npy` directory of its decoded
    frames load to equal arrays (load_video, probes, sampling), and equal
    JAX's load of the JPEGs."""
    from PIL import Image
    rng = np.random.default_rng(0)
    jdir, ndir = tmp_path / "jpg", tmp_path / "npy"
    jdir.mkdir()
    ndir.mkdir()
    for t in range(7):
        Image.fromarray(rng.integers(0, 255, (24, 40, 3), dtype=np.uint8)
                        ).save(jdir / f"{t:06d}.jpg")
        decoded = np.asarray(Image.open(jdir / f"{t:06d}.jpg").convert("RGB"))
        np.save(ndir / f"{t:06d}.npy", decoded)
    for kw in ({}, {"max_frames": 4}):
        a = np.stack(list(tvideo.load_video(str(jdir), **kw)))
        b = np.stack(list(tvideo.load_video(str(ndir), **kw)))
        w = np.stack(list(jvideo.load_video(str(jdir), **kw)))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w)
    assert tvideo.probe_video_hw(str(ndir)) == tvideo.probe_video_hw(
        str(jdir)) == (24, 40)
    assert tvideo.probe_video_len(str(ndir)) == 7
