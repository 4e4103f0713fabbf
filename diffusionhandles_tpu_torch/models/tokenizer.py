"""CLIP BPE tokenizer.

Replaces `transformers.CLIPTokenizer` (reference: diffhandles/
guided_stable_diffuser.py:34,95-106): prompts are tokenized with
padding='max_length', truncation, max_length=77.

`CLIPBPETokenizer` implements byte-level BPE with the CLIP end-of-word
convention and loads `vocab.json` / `merges.txt` from a local checkpoint
directory. When no vocab files are available (offline, random-weight runs),
`HashTokenizer` provides a deterministic stand-in with the same interface so
the full pipeline stays runnable.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import json
import pathlib
import re
from typing import List, Optional


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2/CLIP reversible byte <-> unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return set(zip(word[:-1], word[1:]))


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# CLIP's token pattern (ASCII-equivalent of the \p{L}/\p{N} classes; prompts
# in this framework's test sets are English).
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE)


class CLIPBPETokenizer:
    """Byte-level BPE with CLIP's `</w>` end-of-word marker."""

    def __init__(self, vocab_path: str, merges_path: str,
                 max_length: int = 77, pad_token_id: Optional[int] = None):
        with open(vocab_path, "r", encoding="utf-8") as f:
            self.encoder = json.load(f)
        merges_path = pathlib.Path(merges_path)
        if merges_path.suffix == ".gz":
            merges = gzip.open(merges_path, "rt",
                               encoding="utf-8").read().split("\n")
        else:
            merges = merges_path.read_text(encoding="utf-8").split("\n")
        merges = [m for m in merges if m and not m.startswith("#version")]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_token_id = self.encoder.get("<|startoftext|>", 49406)
        self.eos_token_id = self.encoder.get("<|endoftext|>", 49407)
        # SD-2's tokenizer pads with '!' (id 0); SD-1 pads with eos.
        self.pad_token_id = (pad_token_id if pad_token_id is not None
                             else self.encoder.get("!", 0))
        self.model_max_length = max_length
        self._cache = {}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
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
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
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
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        text = _whitespace_clean(text).lower()
        ids: List[int] = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts, padding: str = "max_length",
                 truncation: bool = True, max_length: Optional[int] = None):
        """Returns a list of fixed-length id lists (HF-call parity)."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = []
        for text in texts:
            ids = [self.bos_token_id] + self.tokenize(text)
            ids = ids[:max_length - 1] + [self.eos_token_id]
            if padding == "max_length":
                ids = ids + [self.pad_token_id] * (max_length - len(ids))
            out.append(ids)
        return out


class HashTokenizer:
    """Deterministic fallback tokenizer for offline random-weight runs.

    Maps each word to a stable pseudo-id; NOT compatible with real CLIP
    weights — it exists so the pipeline is runnable end-to-end without
    vocab files.
    """

    def __init__(self, vocab_size: int = 49408, max_length: int = 77,
                 pad_token_id: int = 0):
        self.vocab_size = vocab_size
        self.model_max_length = max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = pad_token_id

    def tokenize(self, text: str) -> List[int]:
        words = _whitespace_clean(text).lower().split(" ")
        ids = []
        for w in words:
            if not w:
                continue
            digest = hashlib.sha256(w.encode()).digest()
            ids.append(1 + int.from_bytes(digest[:4], "little")
                       % (self.vocab_size - 3))
        return ids

    def __call__(self, texts, padding: str = "max_length",
                 truncation: bool = True, max_length: Optional[int] = None):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = []
        for text in texts:
            ids = [self.bos_token_id] + self.tokenize(text)
            ids = ids[:max_length - 1] + [self.eos_token_id]
            ids = ids + [self.pad_token_id] * (max_length - len(ids))
            out.append(ids)
        return out


def load_tokenizer(checkpoint_dir: Optional[str],
                   max_length: int = 77, vocab_size: int = 49408,
                   allow_hash_fallback: bool = False):
    """Load the real CLIP tokenizer from `checkpoint_dir/tokenizer`.

    With no checkpoint_dir (offline random-weight runs) the deterministic
    HashTokenizer stand-in is returned. When a checkpoint_dir IS given but
    its vocab files are missing, this FAILS instead of silently hashing the
    prompts (real weights + hashed token ids would destroy the conditioning
    without any visible error); pass allow_hash_fallback=True to override
    knowingly.
    """
    if checkpoint_dir is not None:
        tok_dir = pathlib.Path(checkpoint_dir) / "tokenizer"
        vocab = tok_dir / "vocab.json"
        merges = tok_dir / "merges.txt"
        merges_gz = tok_dir / "merges.txt.gz"
        if vocab.exists() and merges_gz.exists() and not merges.exists():
            merges = merges_gz
        if vocab.exists() and merges.exists():
            return CLIPBPETokenizer(str(vocab), str(merges),
                                    max_length=max_length)
        if not allow_hash_fallback:
            raise FileNotFoundError(
                f"checkpoint_dir given but tokenizer vocab files are missing "
                f"({vocab}, {merges}); refusing the hash-tokenizer fallback "
                f"with real weights. Pass allow_hash_fallback=True to "
                f"override.")
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
