# Copied from passl_tpu/data/tokenizer.py; the port keeps its own copy and imports nothing of passl_tpu.
# Unchanged: DEFAULT_BPE_PATH finds the vocabulary beside this file, passl_tpu_torch/data/assets/.
"""CLIP-compatible BPE tokenizer.

Capability parity with reference `passl_v110/modeling/utils/tokenizer.py`
(`SimpleTokenizer:65`): byte-level BPE over a merges vocabulary with
<|startoftext|>/<|endoftext|> specials and fixed context length. The
merges file (e.g. the standard 16e6 CLIP vocabulary, optionally .gz) is
vendored in-package (`data/assets/bpe_simple_vocab_16e6.txt.gz`, the
standard public CLIP vocabulary, same asset the reference ships at
`passl_v110/utils/bpe_simple_vocab_16e6.txt.gz`) and used by default,
so out-of-the-box text encoding matches reference/CLIP semantics
(vocab_size 49408, sot 49406, eot 49407). Pass ``bpe_path=""`` to get
the deterministic byte-level fallback vocabulary (no merges) for
asset-free unit tests.
"""
from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte ↔ printable-unicode mapping (standard GPT-2/CLIP
    byte-level BPE alphabet)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


DEFAULT_BPE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "assets", "bpe_simple_vocab_16e6.txt.gz")


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None, context_length: int = 77):
        if bpe_path is None:
            bpe_path = DEFAULT_BPE_PATH
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges: List[tuple] = []
        if bpe_path and os.path.exists(bpe_path):
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # standard format: first line is a version header
            for line in lines[1 : 49152 - 256 - 2 + 1]:
                parts = tuple(line.split())
                if len(parts) == 2:
                    merges.append(parts)
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        # ASCII approximation of the \p{L}/\p{N} classes (stdlib `re`
        # lacks unicode property escapes; non-ASCII falls through to the
        # final catch-all group, which byte-level BPE handles fine)
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
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
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            if token in ("<|startoftext|>", "<|endoftext|>"):
                bpe_tokens.append(self.encoder[token])
                continue
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token_b).split(" ")
                              if t in self.encoder)
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(t), "") for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(self, texts: Union[str, Sequence[str]], context_length: Optional[int] = None) -> np.ndarray:
        """[B, context_length] int32, sot + tokens + eot, zero padded,
        truncated keeping eot (reference tokenize semantics)."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), np.int32)
        for i, t in enumerate(texts):
            toks = [self.sot] + self.encode(t) + [self.eot]
            if len(toks) > ctx:
                toks = toks[: ctx - 1] + [self.eot]
            out[i, : len(toks)] = toks
        return out
