"""The byte-level tokenizer stub of the weightless runs, and the keyword
stopping criterion of stepwise decode.

Copies of `ByteTokenizer` and `KeywordsStoppingCriteria`
(flash_vstream_tpu/preprocess/tokenizer.py:43, 106-135), so the port
imports nothing of the JAX package. Real deployments load an HF
tokenizer from local files, which waits for checkpoints (ROADMAP A10).
"""
from __future__ import annotations

from typing import List, Sequence


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
