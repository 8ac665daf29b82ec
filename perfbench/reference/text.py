"""Prompts for the reference: CLIP's byte-level BPE tokenizer on the vocabulary
files the benchmark writes, and Prompt-to-Prompt's per-prompt tensors (the
refinement mapper from a Needleman-Wunsch alignment of the token ids, the
cross-replace schedule, the reweighting vector, LocalBlend's word selector),
after the published P2P code (google/prompt-to-prompt ``seq_aligner.py`` and
``ptp_utils.py``), in numpy. A frozen copy kept with the benchmark.
"""
from __future__ import annotations

import json
import os
import re
from typing import List, Sequence

import numpy as np

MAX_WORDS = 77
_PAT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]"
                  r"|[^\sa-zA-Z0-9]+", re.IGNORECASE)


def bytes_to_unicode() -> dict:
    """GPT-2's reversible byte <-> unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class Tokenizer:
    """CLIP BPE on ``vocab.json`` + ``merges.txt``; pads with the end token."""

    def __init__(self, vocab_dir: str):
        with open(os.path.join(vocab_dir, "vocab.json")) as f:
            self.encoder = json.load(f)
        with open(os.path.join(vocab_dir, "merges.txt")) as f:
            lines = [ln for ln in f.read().split("\n")[1:] if len(ln.split()) == 2]
        self.ranks = {tuple(ln.split()): i for i, ln in enumerate(lines)}
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> List[str]:
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return word

    def encode(self, text: str) -> List[int]:
        ids = [self.bos]
        for tok in _PAT.findall(re.sub(r"\s+", " ", text).strip().lower()):
            ids += [self.encoder[p] for p in
                    self._bpe("".join(self.byte_enc[b] for b in tok.encode("utf-8")))]
        return ids + [self.eos]

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_dec[c] for c in text if c in self.byte_dec)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def ids(self, texts: Sequence[str], length: int = MAX_WORDS) -> np.ndarray:
        out = []
        for t in texts:
            ids = self.encode(t)
            ids = ids[: length - 1] + [self.eos] if len(ids) > length else ids
            out.append(ids + [self.eos] * (length - len(ids)))
        return np.asarray(out, np.int64)


def word_inds(text: str, word, tok: Tokenizer) -> np.ndarray:
    """The token positions (BOS at 0) that spell ``word`` (a string or a word index)."""
    split = text.split(" ")
    places = [i for i, w in enumerate(split) if w == word] if isinstance(word, str) else [word]
    pieces = [tok.decode([t]).strip("#") for t in tok.encode(text)][1:-1]
    out, length, ptr = [], 0, 0
    for i, piece in enumerate(pieces):
        length += len(piece)
        if ptr in places:
            out.append(i + 1)
        if ptr < len(split) and length >= len(split[ptr]):
            ptr, length = ptr + 1, 0
    return np.asarray(out, np.int64)


def refinement_mapper(src: str, tgt: str, tok: Tokenizer):
    """(mapper, alphas), each (77,): the target token j takes the source token
    mapper[j]'s attention where alphas[j] is 1 (a global alignment of the ids,
    gap 0, match 1, mismatch -1)."""
    x, y = tok.encode(src), tok.encode(tgt)
    nx, ny = len(x), len(y)
    score = np.zeros((nx + 1, ny + 1), np.int64)
    trace = np.zeros((nx + 1, ny + 1), np.int64)
    trace[0, 1:], trace[1:, 0], trace[0, 0] = 1, 2, 4
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            left, up = score[i, j - 1], score[i - 1, j]
            diag = score[i - 1, j - 1] + (1 if x[i - 1] == y[j - 1] else -1)
            best = max(left, up, diag)
            score[i, j] = best
            trace[i, j] = 1 if best == left else 2 if best == up else 3
    pairs, i, j = [], nx, ny
    while i > 0 or j > 0:
        if trace[i, j] == 3:
            i, j = i - 1, j - 1
            pairs.append((j, i))
        elif trace[i, j] == 1:
            j -= 1
            pairs.append((j, -1))
        elif trace[i, j] == 2:
            i -= 1
        else:
            break
    pairs = np.asarray(pairs[::-1], np.int64).reshape(-1, 2)
    alphas = np.ones(MAX_WORDS, np.float32)
    alphas[: len(pairs)] = (pairs[:, 1] != -1)
    mapper = np.zeros(MAX_WORDS, np.int64)
    mapper[: len(pairs)] = pairs[:, 1]
    mapper[len(pairs):] = ny + np.arange(MAX_WORDS - ny)
    return mapper, alphas


def cross_replace_alpha(steps: int, fraction: float) -> np.ndarray:
    """(steps + 1, 77): 1 on the first ``int(fraction * (steps + 1))`` steps."""
    alpha = np.zeros((steps + 1, MAX_WORDS), np.float32)
    alpha[: int(fraction * (steps + 1))] = 1.0
    return alpha


def equalizer(text: str, words: Sequence[str], values: Sequence[float], tok) -> np.ndarray:
    eq = np.ones(MAX_WORDS, np.float32)
    for w, v in zip(words, values):
        eq[word_inds(text, w, tok)] = v
    return eq


def word_selector(prompts: Sequence[str], words: Sequence[str], tok) -> np.ndarray:
    """(len(prompts), 77): 1 at the tokens of each prompt's blend word."""
    sel = np.zeros((len(prompts), MAX_WORDS), np.float32)
    for i, (p, w) in enumerate(zip(prompts, words)):
        sel[i, word_inds(p, w, tok)] = 1.0
    return sel
