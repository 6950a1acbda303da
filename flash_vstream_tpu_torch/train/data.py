"""Supervised training data: the LLaVA family's conversations, datasets and
collators, and the modality schedule.

Port of flash_vstream_tpu/train/data.py:34-509, the rebuild of the
reference's dataset and collator stack (Flash-VStream-LLaVA/flash_vstream/
train/train.py:428-853: preprocess_v1 / preprocess_plain,
LazySupervisedDataset with precomputed-feature loading,
DataCollatorForSupervisedDataset; vstream_trainer.py:56-148
LengthGroupedSampler). Everything here is numpy on the host, as in JAX:

- the conversation json schema is the reference's ({id, video? | image?,
  conversations: [{from: human|gpt, value}]});
- video features load from `.safetensors` through the port's own reader
  (key `feature`, else the first) or from `.npy`; raw frame directories
  (`.npy` frames with numpy, JPEG/PNG with PIL) through preprocess/video;
  a single image `.npy` with numpy, any other file with PIL, imported
  only then;
- every batch is padded to a fixed (frame bucket, pre-image length,
  post-image length), so the spliced sequence has one shape and the image
  splice slot is the same for the whole batch (the pre-image segment is
  left-padded).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from ..preprocess.prompts import conv_templates
from ..preprocess.tokenizer import tokenizer_image_token


def _conversation(name: str, conversations: List[dict]):
    """The template `name` filled with the turns (a leading non-human turn
    dropped) and its prompt."""
    conv = conv_templates[name].copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    src = conversations
    if src and roles.get(src[0]["from"]) != conv.roles[0]:
        src = src[1:]
    for s in src:
        conv.append_message(roles[s["from"]], s["value"])
    return conv, conv.get_prompt()


def _tokenize_fn(tokenizer, has_image: bool):
    def tok(text):
        if has_image:
            return tokenizer_image_token(text, tokenizer).tolist()
        return list(tokenizer.encode(text))
    return tok


def _start(input_ids: np.ndarray, tokenizer) -> int:
    """1 past a leading BOS (the reference's cur_len = 1, train.py:464),
    since the per-round token counts exclude it."""
    return 1 if len(input_ids) and input_ids[0] == getattr(
        tokenizer, "bos_token_id", None) else 0


def preprocess_v1(conversations: List[dict], tokenizer,
                  has_image: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Vicuna-v1 rounds with assistant-only supervision (train.py:428-507):
    the prompt is the whole conversation; labels are IGNORE but on the
    assistant replies, whose spans are found by tokenizing each round and
    its instruction part."""
    conv, prompt = _conversation("vicuna_v1", conversations)
    tok = _tokenize_fn(tokenizer, has_image)
    input_ids = np.asarray(tok(prompt), np.int64)
    labels = np.full_like(input_ids, IGNORE_INDEX)
    sep2 = conv.sep2
    cur = _start(input_ids, tokenizer)
    for r in prompt.split(sep2):
        if not r:
            continue
        full_round = r + sep2
        parts = full_round.split(conv.roles[1] + ": ")
        round_len = len(tok(full_round)) - 1          # strip per-chunk BOS
        if len(parts) == 2:
            instruction_len = len(tok(parts[0] + conv.roles[1] + ": ")) - 1
            lo, hi = cur + instruction_len, cur + round_len
            labels[lo:hi] = input_ids[lo:hi]
        cur += round_len
    return input_ids, labels


def preprocess_llama_2(conversations: List[dict], tokenizer,
                       has_image: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Llama-2 chat with assistant-only supervision (train.py:345-425):
    rounds split on '</s>', each supervised after '[/INST] '."""
    conv, prompt = _conversation("llama_2", conversations)
    tok = _tokenize_fn(tokenizer, has_image)
    input_ids = np.asarray(tok(prompt), np.int64)
    labels = np.full_like(input_ids, IGNORE_INDEX)
    sep = "[/INST] "
    cur = _start(input_ids, tokenizer)
    for r in prompt.split(conv.sep2):
        if not r:
            continue
        full_round = r + conv.sep2
        parts = full_round.split(sep)
        round_len = len(tok(full_round)) - 1          # strip per-chunk BOS
        if len(parts) == 2:
            instruction_len = len(tok(parts[0] + sep)) - 1
            labels[cur + instruction_len:cur + round_len] = \
                input_ids[cur + instruction_len:cur + round_len]
        cur += round_len
    return input_ids, labels


def preprocess_mpt(conversations: List[dict], tokenizer,
                   has_image: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """MPT/ChatML with assistant-only supervision (train.py:509-575): the
    prompt splits on '<|im_end|>'; a chunk opening with the assistant role
    is supervised past the role header, its closing separator included
    (the reference's round_len includes it, train.py:556)."""
    conv, prompt = _conversation("mpt", conversations)
    tok = _tokenize_fn(tokenizer, has_image)
    input_ids = np.asarray(tok(prompt), np.int64)
    labels = np.full_like(input_ids, IGNORE_INDEX)
    cur = _start(input_ids, tokenizer)
    chunks = prompt.split(conv.sep)
    for i, chunk in enumerate(chunks):
        if not chunk:
            continue
        piece = chunk + conv.sep if i < len(chunks) - 1 else chunk
        n = len(tok(piece)) - 1                       # strip per-chunk BOS
        if chunk.startswith(conv.roles[1]):
            ins = len(tok(conv.roles[1])) - 1
            labels[cur + ins:cur + n] = input_ids[cur + ins:cur + n]
        cur += n
    return input_ids, labels


PREPROCESS_BY_VERSION = {
    "v1": preprocess_v1,
    "vicuna_v1": preprocess_v1,
    "llama_2": preprocess_llama_2,
    "mpt": preprocess_mpt,
}


def preprocess_plain(conversations: List[dict], tokenizer
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Pretrain style: '<image>caption\\n' with the caption supervised
    (train.py:576-595)."""
    if len(conversations) != 2:
        raise ValueError(f"the plain template takes one caption turn pair, "
                         f"got {len(conversations)} turns")
    prompt = "<image>" + conversations[1]["value"] + "\n"
    input_ids = tokenizer_image_token(prompt, tokenizer)
    labels = input_ids.copy()
    (img_pos,) = np.where(input_ids == IMAGE_TOKEN_INDEX)
    labels[:img_pos[0] + 1] = IGNORE_INDEX       # up to and incl. the image
    return input_ids, labels


@dataclasses.dataclass
class DataConfig:
    data_path: str = ""
    video_dir: str = ""
    feature_dir: Optional[str] = None     # precomputed .safetensors features
    video_max_frames: int = 50
    conv_version: str = "v1"              # or "plain"
    frame_bucket: int = 64
    max_text_len: int = 512
    image_size: int = 224                 # host resize target for raw media
    # raw-video subsampling beyond video_max_frames (reference
    # DataArguments.video_sample_type, train.py:86 + 768-780): "" evenly
    # spaced; "center" the middle window; "uniform" round((i+1)*scale - 1)
    video_sample_type: str = ""


def breakpoint_slice_features(feature: np.ndarray, item: dict) -> np.ndarray:
    """Breakpoint-mode time slicing of precomputed features (the reference
    LazySupervisedDataset, train.py:740-756): an item with a 'time' key
    keeps a window around the question's time, +-15 frames, +-9 with a
    'time_9' key, +-54 around time_9dense // 4 with a 'time_9dense' key; an
    item with only 'time_9dense' keeps every 6th frame."""
    if "time" in item:
        if "time_9dense" in item:
            tim = int(item["time_9dense"]) // 4
            start = max(tim - 6 * 9, 0)
            end = min(tim + 6 * 9, feature.shape[0])
        else:
            expansion = 9 if "time_9" in item else 15
            tim = int(item["time"])
            start = max(tim - expansion, 0)
            end = min(tim + expansion, feature.shape[0])
        return feature[start:end]
    if "time_9dense" in item:
        return feature[::6]
    return feature


def sample_type_indices(n: int, max_frames: int, sample_type: str) -> list:
    """Indices into the fps-sampled frame list beyond max_frames (reference
    train.py:768-780)."""
    idx = list(range(n))
    if n <= max_frames:
        return idx
    if sample_type == "center":
        start = (n - max_frames) // 2
        return idx[start:start + max_frames]
    if sample_type == "uniform":
        scale = 1.0 * n / max_frames
        # python round(): half to even, as the reference
        return [idx[round((i + 1) * scale - 1)] for i in range(max_frames)]
    if n > 18000:
        # the reference's cap for un-typed huge videos
        scale = 1.0 * n / 180
        return [idx[round((i + 1) * scale - 1)] for i in range(180)]
    return idx


def load_feature_file(base: str) -> np.ndarray:
    """The [T, P, D] features of `base` + '.safetensors' (key 'feature',
    else the first) or '.npy' (`base` may carry either extension)."""
    from ..weights.safetensors_io import load_file
    for ext in (".safetensors", ".npy"):
        p = base if base.endswith(ext) else base + ext
        if os.path.exists(p):
            if p.endswith(".safetensors"):
                import torch
                d = load_file(p)
                t = d["feature"] if "feature" in d else next(iter(d.values()))
                # numpy has no bfloat16
                return (t.float() if t.dtype == torch.bfloat16
                        else t).numpy().copy()
            return np.load(p)
    raise FileNotFoundError(base)


class SupervisedVideoDataset:
    """Lazy dataset over a conversation json and its videos, features or
    images (LazySupervisedDataset, train.py:645-816)."""

    def __init__(self, cfg: DataConfig, tokenizer, retries: int = 10,
                 rng: Optional[random.Random] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        with open(cfg.data_path) as f:
            self.items = json.load(f)
        self.retries = retries
        self.rng = rng or random.Random(0)

    def __len__(self):
        return len(self.items)

    def _load_video_features(self, name: str) -> np.ndarray:
        return load_feature_file(os.path.join(self.cfg.feature_dir, name))

    def _subsample(self, x: np.ndarray) -> np.ndarray:
        T, m = x.shape[0], self.cfg.video_max_frames
        if T > m:
            x = x[np.linspace(0, T - 1, m).round().astype(int)]
        return x

    def _frames(self, item: dict) -> list:
        """The raw-video branch (train.py:764-793): decoded frames, padded
        to a square and resized on the host (uint8)."""
        from ..preprocess.image import clip_resize_u8
        from ..preprocess.video import load_video
        path = os.path.join(self.cfg.video_dir, item["video"])
        if self.cfg.video_sample_type:
            frames = list(load_video(path))
            sel = sample_type_indices(len(frames), self.cfg.video_max_frames,
                                      self.cfg.video_sample_type)
            frames = [frames[j] for j in sel]
        else:
            frames = list(load_video(path,
                                     max_frames=self.cfg.video_max_frames))
        return list(clip_resize_u8(frames, self.cfg.image_size))

    def __getitem__(self, i: int) -> dict:
        """{'input_ids', 'labels', 'id'} and 'features' or 'frames' (with
        'n_frames') or 'image_frame'. A corrupt item is replaced by a random
        one, up to `retries` times (train.py:680-793)."""
        for attempt in range(self.retries):
            item = self.items[i]
            try:
                conv = item["conversations"]
                if self.cfg.conv_version == "plain":
                    ids, labels = preprocess_plain(conv, self.tokenizer)
                else:
                    fn = PREPROCESS_BY_VERSION[self.cfg.conv_version]
                    ids, labels = fn(conv, self.tokenizer,
                                     has_image="video" in item
                                     or "image" in item)
                out = {"input_ids": ids, "labels": labels,
                       "id": item.get("id", i)}
                if "video" in item:
                    if self.cfg.feature_dir:
                        feats = np.asarray(
                            self._load_video_features(item["video"]),
                            np.float32)
                        feats = breakpoint_slice_features(feats, item)
                        out["features"] = self._subsample(feats)
                        out["n_frames"] = out["features"].shape[0]
                    else:
                        out["frames"] = self._frames(item)
                        out["n_frames"] = len(out["frames"])
                elif "image" in item:
                    # single image (train.py:694-716): its full patch
                    # features spliced with no memory
                    from ..preprocess.image import clip_resize_u8
                    from ..preprocess.video import read_frame
                    img = read_frame(os.path.join(self.cfg.video_dir,
                                                  item["image"]))
                    out["image_frame"] = clip_resize_u8(
                        [img], self.cfg.image_size)[0]
                return out
            except Exception:
                if attempt == self.retries - 1:
                    raise
                i = self.rng.randrange(len(self.items))
        raise RuntimeError("unreachable")

    def modality_lengths(self) -> List[int]:
        """Word counts, positive for multimodal items and negative for
        text-only ones (the LengthGroupedSampler's input,
        vstream_trainer.py:117-148)."""
        out = []
        for item in self.items:
            n = sum(len(c["value"].split()) for c in item["conversations"])
            out.append(n if ("video" in item or "image" in item) else -n)
        return out


def proportional_schedule(sizes: Dict, total_steps: int) -> List:
    """Deterministic largest-remainder interleaving: each step draws from one
    group, groups picked in proportion to their size (a 9:1 dataset trains
    its groups 9:1). Keys keep their insertion order for tie-breaking."""
    keys = list(sizes)
    total = sum(sizes.values())
    credit = {k: 0.0 for k in keys}
    schedule = []
    for _ in range(total_steps):
        for k in keys:
            credit[k] += sizes[k] / total
        pick = max(keys, key=lambda k: credit[k])
        credit[pick] -= 1.0
        schedule.append(pick)
    return schedule


def length_grouped_indices(lengths: Sequence[int], batch_size: int,
                           world_size: int, seed: int = 0) -> List[int]:
    """Modality-grouped megabatch shuffling (vstream_trainer.py:56-114):
    multimodal and text-only samples in separate megabatches, each sorted
    by length, the megabatches shuffled."""
    rng = random.Random(seed)
    mm = [i for i, n in enumerate(lengths) if n > 0]
    lang = [i for i, n in enumerate(lengths) if n <= 0]
    rng.shuffle(mm)
    rng.shuffle(lang)
    mega = world_size * batch_size

    def make_megabatches(idx):
        batches = [idx[i:i + mega] for i in range(0, len(idx), mega)]
        return [sorted(b, key=lambda j: abs(lengths[j]), reverse=True)
                for b in batches]

    megabatches = make_megabatches(mm) + make_megabatches(lang)
    rng.shuffle(megabatches)
    return [i for b in megabatches for i in b]


def collate_llava(samples: List[dict], frame_bucket: int, pad_id: int,
                  max_text_len: int = 512,
                  fixed_pre_len: Optional[int] = None,
                  fixed_post_len: Optional[int] = None
                  ) -> Dict[str, np.ndarray]:
    """One fixed-shape batch: each sequence split at its image token, the
    pre segment left-padded and the post segment right-padded, so the
    splice slot is the batch's (fixed_pre/post_len keep it across
    batches); features or frames padded to `frame_bucket`."""
    pres, posts, lpres, lposts = [], [], [], []
    for s in samples:
        ids, labels = s["input_ids"], s["labels"]
        (img_pos,) = np.where(ids == IMAGE_TOKEN_INDEX)
        p = int(img_pos[0])
        pres.append(ids[:p][-max_text_len:])
        posts.append(ids[p + 1:][:max_text_len])
        lpres.append(labels[:p][-max_text_len:])
        lposts.append(labels[p + 1:][:max_text_len])
    P = fixed_pre_len or max(len(x) for x in pres)
    Q = fixed_post_len or max(len(x) for x in posts)
    pres = [x[-P:] for x in pres]
    posts = [x[:Q] for x in posts]
    lpres = [x[-P:] for x in lpres]
    lposts = [x[:Q] for x in lposts]
    B = len(samples)

    input_ids = np.full((B, P + 1 + Q), pad_id, np.int64)
    for b in range(B):
        input_ids[b, P - len(pres[b]):P] = pres[b]
        input_ids[b, P] = IMAGE_TOKEN_INDEX
        input_ids[b, P + 1:P + 1 + len(posts[b])] = posts[b]

    if "features" in samples[0]:
        Pp, D = samples[0]["features"].shape[1:]
        feats = np.zeros((B, frame_bucket, Pp, D), np.float32)
        for b, s in enumerate(samples):
            feats[b, :s["n_frames"]] = s["features"]
        media = {"features": feats}
        n_frames = [min(s["n_frames"], frame_bucket) for s in samples]
    elif "image_frame" in samples[0]:
        media = {"image": np.stack([s["image_frame"] for s in samples])}
        n_frames = [1] * B
    else:
        shp = samples[0]["frames"][0].shape
        frames = np.zeros((B, frame_bucket, *shp), np.uint8)
        for b, s in enumerate(samples):
            for t, f in enumerate(s["frames"][:frame_bucket]):
                frames[b, t] = f
        media = {"frames": frames}
        n_frames = [min(s["n_frames"], frame_bucket) for s in samples]

    return {
        "input_ids": input_ids, "image_slot": P,
        "n_frames": np.asarray(n_frames, np.int32),
        "pre_lens": np.asarray([len(x) for x in pres], np.int32),
        "labels_pre": _pad_left(lpres, P),
        "labels_post": _pad_right(lposts, Q),
        **media,
    }


def collate_text(samples: List[dict], pad_id: int, fixed_len: int
                 ) -> Dict[str, np.ndarray]:
    """A text-only batch (no media, no splice), right-padded to fixed_len
    (the reference's text-only path, train.py:803-816)."""
    B = len(samples)
    ids = np.full((B, fixed_len), pad_id, np.int64)
    labels = np.full((B, fixed_len), IGNORE_INDEX, np.int64)
    seg = np.full((B, fixed_len), -1, np.int32)
    for b, s in enumerate(samples):
        x, lab = s["input_ids"][:fixed_len], s["labels"][:fixed_len]
        ids[b, :len(x)] = x
        labels[b, :len(lab)] = lab
        seg[b, :len(x)] = 0
    return {"input_ids": ids, "labels": labels, "segments": seg}


def _pad_left(xs, n):
    out = np.full((len(xs), n), IGNORE_INDEX, np.int64)
    for i, x in enumerate(xs):
        if len(x):
            out[i, n - len(x):] = x
    return out


def _pad_right(xs, n):
    out = np.full((len(xs), n), IGNORE_INDEX, np.int64)
    for i, x in enumerate(xs):
        if len(x):
            out[i, :len(x)] = x
    return out


def spliced_labels(batch: Dict[str, np.ndarray], n_mem: int) -> np.ndarray:
    """Labels of the spliced layout [pre | n_mem memory tokens (IGNORE) |
    post]."""
    B = batch["labels_pre"].shape[0]
    mem = np.full((B, n_mem), IGNORE_INDEX, np.int64)
    return np.concatenate([batch["labels_pre"], mem, batch["labels_post"]], 1)


def spliced_segments(batch: Dict[str, np.ndarray], n_mem: int,
                     pad_id: int) -> np.ndarray:
    """Segment ids of the spliced layout: -1 at padding, 0 elsewhere (a
    real token whose id is pad_id counts as padding, as in JAX)."""
    ids = batch["input_ids"]
    P = batch["image_slot"]
    B, S = ids.shape
    pre_valid = np.zeros((B, P), np.int32) - (ids[:, :P] == pad_id)
    post_valid = (np.zeros((B, S - P - 1), np.int32)
                  - (ids[:, P + 1:] == pad_id))
    mem = np.zeros((B, n_mem), np.int32)
    return np.concatenate([pre_valid, mem, post_valid], 1)
