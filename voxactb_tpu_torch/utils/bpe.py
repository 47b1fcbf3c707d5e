"""Byte-level BPE tokenizer (CLIP flavor) for language-goal encoding.

A copy of ``voxactb_tpu.utils.bpe`` (host-only code) so the port imports
nothing of the JAX package. It implements the standard public CLIP
tokenization algorithm (byte->unicode mapping, greedy pair merging,
``<|startoftext|>``/``<|endoftext|>`` framing, context 77). The merge table is
DATA: the public OpenAI CLIP ``bpe_simple_vocab_16e6.txt.gz``, kept with this
package under ``voxactb_tpu_torch/assets/``; override with an explicit path or
``VOXACTB_BPE_VOCAB``. A deterministic hash fallback exists for vocab-free
smoke runs but must be opted into with ``allow_hash_fallback=True`` (hash ids
are stable but NOT CLIP-compatible, so it is an error by default).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List, Optional, Sequence, Union

import numpy as np

CONTEXT_LENGTH = 77
SOT = 49406
EOT = 49407

_DEFAULT_VOCAB_PATHS = [
    os.environ.get("VOXACTB_BPE_VOCAB", ""),
    os.path.join(os.path.dirname(__file__), "..", "assets",
                 "bpe_simple_vocab_16e6.txt.gz"),
]


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (the standard GPT-2/CLIP table)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text.strip()).lower()


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None,
                 allow_hash_fallback: bool = False):
        path = bpe_path
        if path is None:
            for cand in _DEFAULT_VOCAB_PATHS:
                if cand and os.path.exists(cand):
                    path = cand
                    break
        self._fallback = path is None
        if self._fallback:
            if not allow_hash_fallback:
                raise FileNotFoundError(
                    "CLIP BPE merge table not found (looked at "
                    f"{[p for p in _DEFAULT_VOCAB_PATHS if p]}); pass bpe_path=, "
                    "set VOXACTB_BPE_VOCAB, or opt into the non-CLIP hash "
                    "tokenizer with allow_hash_fallback=True")
            return

        with gzip.open(path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        # stdlib-re approximation of the CLIP pattern (\p{L}/\p{N} classes need the
        # third-party `regex` module; ASCII letter/digit classes are equivalent for
        # the English task descriptions this framework consumes)
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        if self._fallback:
            # deterministic hash ids in [1000, 49000) — stable, not CLIP-compatible
            return [1000 + (hash(w) % 48000) for w in _clean(text).split(" ") if w]
        ids: List[int] = []
        for tok in re.findall(self.pat, _clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        if self._fallback:
            raise NotImplementedError("hash-fallback tokenizer cannot decode")
        text = "".join(self.decoder[i] for i in ids)
        return bytearray(
            self.byte_decoder[c] for c in text
        ).decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts: Union[str, Sequence[str]],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Texts -> [N, 77] int32 with SOT/EOT framing (clip.py:635-664)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [SOT] + self.encode(t)[: context_length - 2] + [EOT]
            out[i, : len(ids)] = ids
        return out
