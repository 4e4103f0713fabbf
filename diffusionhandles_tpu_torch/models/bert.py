"""BERT text encoder and a WordPiece tokenizer, release-convertible.

The counterpart of the JAX package's `models/bert.py`: GroundingDINO's
text tower (bert-base-uncased). Word + position + token-type embeddings
with a LayerNorm, post-LN layers, a tanh pooler. The position ids may be
given (GroundingDINO restarts them at every phrase) and the attention
mask may be pairwise [B, S, S].

Module names are the HF `BertModel`'s (under GroundingDINO's `bert.`:
`embeddings.*`, `encoder.layer.N.attention.{self,output}.*`,
`encoder.layer.N.{intermediate,output}.*`, `pooler.dense`). fp32; the
modules do not turn TF32 on.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522              # bert-base-uncased
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def tiny_bert_config(**overrides) -> BertConfig:
    base = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=64)
    base.update(overrides)
    return BertConfig(**base)


def _sub(**modules) -> nn.Module:
    m = nn.Module()
    for name, mod in modules.items():
        m.add_module(name, mod)
    return m


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.num_heads = config.num_heads
        self.attention = _sub(
            self=_sub(query=nn.Linear(d, d), key=nn.Linear(d, d),
                      value=nn.Linear(d, d)),
            output=_sub(dense=nn.Linear(d, d),
                        LayerNorm=nn.LayerNorm(d, eps=eps)))
        self.intermediate = _sub(dense=nn.Linear(d, config.intermediate_size))
        self.output = _sub(dense=nn.Linear(config.intermediate_size, d),
                           LayerNorm=nn.LayerNorm(d, eps=eps))

    def forward(self, x, attn_mask):
        """attn_mask: [B, S] key-padding mask or [B, S, S] pairwise mask
        (GroundingDINO feeds BERT its per-phrase block masks), bool."""
        b, s, d = x.shape
        nh = self.num_heads
        hd = d // nh
        sa = self.attention.self
        q = sa.query(x).view(b, s, nh, hd)
        k = sa.key(x).view(b, s, nh, hd)
        v = sa.value(x).view(b, s, nh, hd)
        logits = torch.einsum("bqhc,bkhc->bhqk", q, k) / np.sqrt(hd)
        mask = (attn_mask[:, None] if attn_mask.dim() == 3
                else attn_mask[:, None, None])
        logits = torch.where(mask, logits, logits.new_tensor(-1e9))
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhc->bqhc", attn, v).reshape(b, s, d)
        ao = self.attention.output
        x = ao.LayerNorm(x + ao.dense(out))
        h = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + h)


class BertModel(nn.Module):
    """input_ids [B, S] + attention_mask ([B, S] padding or [B, S, S]
    pairwise) -> (hidden [B, S, D], pooled [B, D]). `position_ids` [B, S]
    replaces the default arange positions (GroundingDINO restarts them per
    phrase)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        cfg = config
        d = cfg.hidden_size
        self.embeddings = _sub(
            word_embeddings=nn.Embedding(cfg.vocab_size, d),
            position_embeddings=nn.Embedding(cfg.max_position_embeddings, d),
            token_type_embeddings=nn.Embedding(cfg.type_vocab_size, d),
            LayerNorm=nn.LayerNorm(d, eps=cfg.layer_norm_eps))
        self.encoder = _sub(layer=nn.ModuleList(
            [BertLayer(cfg) for _ in range(cfg.num_layers)]))
        self.pooler = _sub(dense=nn.Linear(d, d))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None):
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.bool,
                                        device=input_ids.device)
        attention_mask = attention_mask.bool()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        e = self.embeddings
        x = (e.word_embeddings(input_ids) + e.position_embeddings(position_ids)
             + e.token_type_embeddings(token_type_ids))
        x = e.LayerNorm(x)
        for layer in self.encoder.layer:
            x = layer(x, attention_mask)
        return x, torch.tanh(self.pooler.dense(x[:, 0]))


class WordPieceTokenizer:
    """Greedy-longest-match WordPiece (bert-base-uncased semantics):
    lowercase, punctuation splitting, '##' continuation pieces. Loads a
    real vocab.txt when given; otherwise a hash fallback for random-weight
    runs (Python's `hash`, salted per process by PYTHONHASHSEED, so its ids
    differ between processes; a vocab path that does not exist raises)."""

    CLS, SEP, UNK, PAD = "[CLS]", "[SEP]", "[UNK]", "[PAD]"

    def __init__(self, vocab_path: Optional[str] = None,
                 vocab_size: int = 30522):
        self.vocab_size = vocab_size
        if vocab_path is not None:
            import pathlib
            p = pathlib.Path(vocab_path)
            if not p.exists():
                raise FileNotFoundError(
                    f"BERT vocab file not found: {vocab_path} — refusing "
                    f"the hash fallback for a real-weight run")
            words = p.read_text(encoding="utf-8").splitlines()
            self.vocab = {w: i for i, w in enumerate(words)}
        else:
            self.vocab = None

    def _ids(self, token: str) -> List[int]:
        if self.vocab is None:
            return [hash(token) % (self.vocab_size - 10) + 10]
        if token in (self.CLS, self.SEP, self.PAD):
            return [self.vocab[token]]
        pieces = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.vocab.get(self.UNK, 100)]
            pieces.append(self.vocab[cur])
            start = end
        return pieces

    def _basic(self, text: str) -> List[str]:
        out = []
        word = ""
        for ch in text.lower():
            if ch.isalnum():
                word += ch
            else:
                if word:
                    out.append(word)
                    word = ""
                if not ch.isspace():
                    out.append(ch)
        if word:
            out.append(word)
        return out

    def __call__(self, texts: List[str], max_length: int = 64):
        """-> (ids [B, L] int32, attention_mask [B, L] bool), numpy."""
        batch_ids = []
        for t in texts:
            ids = self._ids(self.CLS) if self.vocab else [101]
            for tok in self._basic(t):
                ids.extend(self._ids(tok))
            ids.extend(self._ids(self.SEP) if self.vocab else [102])
            batch_ids.append(ids[:max_length])
        out = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), bool)
        for i, ids in enumerate(batch_ids):
            out[i, :len(ids)] = ids
            mask[i, :len(ids)] = True
        return out, mask
