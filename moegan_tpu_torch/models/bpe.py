"""CLIP's byte-pair-encoding tokenizer (the port's copy of moegan_tpu/models/bpe.py).

A byte-level BPE over a 49,408-entry vocab built from a merges file
(bpe_simple_vocab_16e6.txt.gz): 256 byte symbols, the same 256 with a
</w> end-of-word marker, 48,894 learned merges, and
<|startoftext|>/<|endoftext|>. With the standard merges file at
CLIP_BPE_PATH (or passed as merges_path) `encode` gives OpenAI CLIP's token
ids. Standard library only; `models/clip.py::tokenize` uses it when a merges
file is on disk.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Iterable, Optional

BPE_PATH_ENV = "CLIP_BPE_PATH"
SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
VOCAB_SIZE = 49408
NUM_MERGES = 49152 - 256 - 2  # 48894, the slice OpenAI's tokenizer takes


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable-unicode map: the 188
    visible latin-1 bytes map to themselves, the rest to 256+offset."""
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


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


# CLIP's token pattern. The original uses \p{L}/\p{N} (regex module);
# Python re's [^\W\d_] matches exactly the unicode-letter class and \d
# the decimal-number class, so this is equivalent.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\w\s]|_)+",
    re.IGNORECASE,
)


class CLIPBPETokenizer:
    """Byte-level BPE with CLIP's </w> end-of-word convention."""

    def __init__(self, merges_path: Optional[str] = None, merges: Optional[list] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        if merges is None:
            if merges_path is None:
                raise ValueError("need merges_path or merges")
            if merges_path.endswith(".gz"):
                with gzip.open(merges_path, "rt", encoding="utf-8") as f:
                    lines = f.read().split("\n")
            else:
                with open(merges_path, encoding="utf-8") as f:
                    lines = f.read().split("\n")
            # OpenAI slice: skip the header line, take exactly NUM_MERGES
            # (tolerate smaller files for tests / reduced vocabs).
            merges = [tuple(m.split()) for m in lines[1 : NUM_MERGES + 1] if m.strip()]

        self.merges: list[tuple[str, str]] = list(merges)
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in self.merges)
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(self.merges)}
        self.cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.sot = self.encoder[SOT_TOKEN]
        self.eot = self.encoder[EOT_TOKEN]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

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
            new_word: list[str] = []
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

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(self, texts, context_length: int = 77) -> "np.ndarray":
        """clip.tokenize contract: [SOT] ids [EOT], zero-padded/truncated
        to context_length (EOT preserved on truncation)."""
        import numpy as np

        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > context_length:
                ids = ids[: context_length - 1] + [self.eot]
            out[i, : len(ids)] = ids
        return out


def find_merges_file(path: Optional[str] = None) -> Optional[str]:
    """Locate a merges file: explicit arg, CLIP_BPE_PATH, or well-known
    names next to the CLIP weights / repo root."""
    candidates = [path, os.environ.get(BPE_PATH_ENV)]
    weights = os.environ.get("CLIP_WEIGHTS_PATH")
    roots = [os.getcwd()]
    if weights:
        roots.insert(0, os.path.dirname(os.path.abspath(weights)))
    for root in roots:
        for name in ("bpe_simple_vocab_16e6.txt.gz", "bpe_simple_vocab_16e6.txt", "merges.txt"):
            candidates.append(os.path.join(root, name))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


@functools.lru_cache(maxsize=1)
def default_tokenizer() -> Optional[CLIPBPETokenizer]:
    """The process-wide tokenizer if a merges file is discoverable."""
    path = find_merges_file()
    return CLIPBPETokenizer(path) if path else None
