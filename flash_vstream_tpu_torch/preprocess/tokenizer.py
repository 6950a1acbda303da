"""The LLaVA prompt's tokenization, the byte-level tokenizer stub of the
weightless runs, the HF tokenizer of a checkpoint directory, and the
keyword stopping criterion of stepwise decode.

Copies of `tokenizer_image_token`, `ByteTokenizer`, `load_tokenizer` and
`KeywordsStoppingCriteria` (flash_vstream_tpu/preprocess/tokenizer.py:19,
43, 100-135), so the port imports nothing of the JAX package.
`load_tokenizer` imports `transformers` only when called.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..core.config import IMAGE_TOKEN_INDEX


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> np.ndarray:
    """The ids of a prompt with '<image>' placeholders, image_token_index
    (-200) at each (mm_utils.py:45-64): the chunks between placeholders
    tokenized apart, a leading BOS kept once. int64 [S]."""
    chunks = [tokenizer.encode(c) for c in prompt.split("<image>")]
    offset = 0
    input_ids: List[int] = []
    if chunks and len(chunks[0]) > 0 and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    for i, x in enumerate(chunks):
        if i:
            input_ids.extend(sep[offset:])
        input_ids.extend(x[offset:])
    return np.asarray(input_ids, np.int64)


class ByteTokenizer:
    """Deterministic byte-level tokenizer stub with an HF-like interface.

    ids 0..255 = bytes; specials appended after. Used for weightless tests
    and dry runs; real runs load an HF tokenizer from local files.
    """

    def __init__(self, specials: Sequence[str] = ()):
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258
        self._specials = {}
        self._special_ids = {}
        next_id = 259
        for s in specials:
            self._specials[s] = next_id
            self._special_ids[next_id] = s
            next_id += 1
        self.vocab_size = next_id

    def special_id(self, token: str) -> int:
        return self._specials[token]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [self.bos_token_id] if add_bos else []
        i = 0
        while i < len(text):
            matched = False
            for s, sid in self._specials.items():
                if text.startswith(s, i):
                    ids.append(sid)
                    i += len(s)
                    matched = True
                    break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if t < 256:
                buf.append(t)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if not skip_special_tokens and t in self._special_ids:
                    out.append(self._special_ids[t])
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


def load_tokenizer(path: str):
    """The HF tokenizer saved in a local directory (no network). Needs
    `transformers`, imported here and only here."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"load_tokenizer({path!r}) needs the `transformers` package, "
            f"which is not installed; build the pipeline with a tokenizer "
            f"object instead (e.g. preprocess.qwen_processor."
            f"make_byte_qwen_tokenizer)") from e
    return AutoTokenizer.from_pretrained(path, local_files_only=True)


class KeywordsStoppingCriteria:
    """Stop generation when any keyword appears in the decoded suffix
    (the reference's mm_utils.py:75-106)."""

    def __init__(self, keywords: Sequence[str], tokenizer, prompt_len: int = 0):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.prompt_len = prompt_len

    def should_stop(self, output_ids: Sequence[int]) -> bool:
        text = self.tokenizer.decode(output_ids[self.prompt_len:],
                                     skip_special_tokens=True)
        return any(k in text for k in self.keywords)

    def single_token_ids(self) -> tuple:
        """The keywords that encode to exactly one token, as token ids. The
        greedy loop checks token ids, not text, so these fold into its EOS
        set ('</s>', '<|im_end|>': decode stops at the keyword)."""
        ids = []
        for k in self.keywords:
            if hasattr(self.tokenizer, "special_id"):      # ByteTokenizer
                toks = self.tokenizer.encode(k, add_bos=False)
            else:
                toks = self.tokenizer.encode(k, add_special_tokens=False)
            if len(toks) == 1:
                ids.append(int(toks[0]))
        return tuple(ids)
