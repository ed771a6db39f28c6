"""CLIP byte-level BPE tokenizer over HF-format vocab files (the port's copy
of the JAX package's utils/clip_bpe.py).

The reference tokenizes with `clip.tokenize`; HF's `CLIPTokenizer` is the
same algorithm. This reads the standard `vocab.json` and `merges.txt`, so a
real OpenAI-CLIP vocabulary drops in where one is on disk. The `regex`
package (its Unicode classes) is imported when a tokenizer is built, never
when this module is: the default text space (utils/text_model.py's hash
projection) needs no tokenizer, and the card's machine has no `regex`.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

PATTERN = r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable-unicode map."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


class CLIPBPETokenizer:
    """Greedy lowest-rank-merge BPE with the word-final `</w>` marker."""

    def __init__(self, vocab_file: str, merges_file: str, context_length: int = 77):
        import regex

        self._re = regex
        self._pat = regex.compile(PATTERN, regex.IGNORECASE)
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines if m and not m.startswith("#version")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.cache: Dict[str, str] = {}
        self.context_length = context_length
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
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
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
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
        """Token ids of one prompt (no special tokens)."""
        text = self._re.sub(r"\s+", " ", text).strip().lower()
        ids: List[int] = []
        for token in self._pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" ") if t in self.encoder)
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """A fixed (n, context_length) int32 grid: sot + ids + eot, zero
        padded, truncated keeping the final eot (CLIP's `tokenize`)."""
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > self.context_length:
                ids = ids[: self.context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out
