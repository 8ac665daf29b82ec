"""Host-side prompt utilities for Prompt-to-Prompt (the port's own copy of
the JAX package's ``utils/text.py`` P2P helpers; pure numpy, computed once per
image).

- word -> token-index lookup (``get_word_inds``);
- the cross-replace alpha schedule (``get_time_words_attention_alpha``);
- the Needleman-Wunsch refinement mapper and the same-length replacement
  matrix (``get_refinement_mapper``, ``get_replacement_mapper``);
- the attention equalizer (``get_equalizer``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

MAX_NUM_WORDS = 77


# ---------------------------------------------------------------------------
# word -> token indices
# ---------------------------------------------------------------------------

def get_word_inds(text: str, word_place: Union[int, str, Sequence[int]], tokenizer) -> np.ndarray:
    """Indices (into the padded token sequence, BOS at 0) of the tokens that
    spell the given word (by position or by string match)."""
    split_text = text.split(" ")
    if isinstance(word_place, str):
        word_place = [i for i, word in enumerate(split_text) if word_place == word]
    elif isinstance(word_place, int):
        word_place = [word_place]
    out: List[int] = []
    if len(word_place) > 0:
        words_encode = [tokenizer.decode([item]).strip("#") for item in tokenizer.encode(text)][1:-1]
        cur_len, ptr = 0, 0
        for i in range(len(words_encode)):
            cur_len += len(words_encode[i])
            if ptr in word_place:
                out.append(i + 1)
            if ptr < len(split_text) and cur_len >= len(split_text[ptr]):
                ptr += 1
                cur_len = 0
    return np.array(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# cross-replace alpha schedule  (steps+1, n_prompts-1, 1, 1, 77)
# ---------------------------------------------------------------------------

def _update_alpha_time_word(alpha: np.ndarray, bounds, prompt_ind: int,
                            word_inds: Optional[np.ndarray] = None) -> np.ndarray:
    if isinstance(bounds, float):
        bounds = (0.0, bounds)
    start, end = int(bounds[0] * alpha.shape[0]), int(bounds[1] * alpha.shape[0])
    if word_inds is None:
        word_inds = np.arange(alpha.shape[2])
    alpha[:start, prompt_ind, word_inds] = 0
    alpha[start:end, prompt_ind, word_inds] = 1
    alpha[end:, prompt_ind, word_inds] = 0
    return alpha


def get_time_words_attention_alpha(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: Union[float, Tuple[float, float], Dict],
    tokenizer,
    max_num_words: int = MAX_NUM_WORDS,
) -> np.ndarray:
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)
    alpha = np.zeros((num_steps + 1, len(prompts) - 1, max_num_words), dtype=np.float32)
    for i in range(len(prompts) - 1):
        alpha = _update_alpha_time_word(alpha, cross_replace_steps["default_"], i)
    for key, item in cross_replace_steps.items():
        if key != "default_":
            inds = [get_word_inds(prompts[i], key, tokenizer) for i in range(1, len(prompts))]
            for i, ind in enumerate(inds):
                if len(ind) > 0:
                    alpha = _update_alpha_time_word(alpha, item, i, ind)
    return alpha.reshape(num_steps + 1, len(prompts) - 1, 1, 1, max_num_words)


# ---------------------------------------------------------------------------
# Needleman-Wunsch global alignment -> refinement mapper
# ---------------------------------------------------------------------------

def _global_align(x: Sequence[int], y: Sequence[int], gap: int, match: int,
                  mismatch: int) -> np.ndarray:
    """Returns the traceback matrix (1=left/gap-in-x, 2=up/gap-in-y, 3=diag)."""
    nx, ny = len(x), len(y)
    score = np.zeros((nx + 1, ny + 1), dtype=np.int32)
    score[0, 1:] = (np.arange(ny) + 1) * gap
    score[1:, 0] = (np.arange(nx) + 1) * gap
    trace = np.zeros((nx + 1, ny + 1), dtype=np.int32)
    trace[0, 1:] = 1
    trace[1:, 0] = 2
    trace[0, 0] = 4
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            left = score[i, j - 1] + gap
            up = score[i - 1, j] + gap
            diag = score[i - 1, j - 1] + (match if x[i - 1] == y[j - 1] else mismatch)
            best = max(left, up, diag)
            score[i, j] = best
            if best == left:
                trace[i, j] = 1
            elif best == up:
                trace[i, j] = 2
            else:
                trace[i, j] = 3
    return trace


def _aligned_mapper_y_to_x(x: Sequence[int], y: Sequence[int], trace: np.ndarray) -> np.ndarray:
    i, j = len(x), len(y)
    mapper: List[Tuple[int, int]] = []
    while i > 0 or j > 0:
        tb = trace[i, j]
        if tb == 3:
            i -= 1
            j -= 1
            mapper.append((j, i))
        elif tb == 1:
            j -= 1
            mapper.append((j, -1))
        elif tb == 2:
            i -= 1
        else:  # 4: corner
            break
    mapper.reverse()
    return np.array(mapper, dtype=np.int64).reshape(-1, 2)


def get_mapper(x: str, y: str, tokenizer, max_len: int = MAX_NUM_WORDS) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token map from target prompt y's positions to source prompt x's,
    with alpha=0 for tokens that have no source counterpart."""
    x_seq = tokenizer.encode(x)
    y_seq = tokenizer.encode(y)
    trace = _global_align(x_seq, y_seq, gap=0, match=1, mismatch=-1)
    base = _aligned_mapper_y_to_x(x_seq, y_seq, trace)
    alphas = np.ones(max_len, dtype=np.float32)
    alphas[: base.shape[0]] = (base[:, 1] != -1).astype(np.float32)
    mapper = np.zeros(max_len, dtype=np.int64)
    mapper[: base.shape[0]] = base[:, 1]
    mapper[base.shape[0]:] = len(y_seq) + np.arange(max_len - len(y_seq))
    return mapper, alphas


def get_refinement_mapper(prompts: Sequence[str], tokenizer,
                          max_len: int = MAX_NUM_WORDS) -> Tuple[np.ndarray, np.ndarray]:
    mappers, alphas = [], []
    for i in range(1, len(prompts)):
        m, a = get_mapper(prompts[0], prompts[i], tokenizer, max_len)
        mappers.append(m)
        alphas.append(a)
    return np.stack(mappers), np.stack(alphas)


def get_replacement_mapper_single(x: str, y: str, tokenizer,
                                  max_len: int = MAX_NUM_WORDS) -> np.ndarray:
    """(max_len, max_len) soft permutation matrix for same-word-count prompts."""
    words_x = x.split(" ")
    words_y = y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edit requires prompts with the same word count "
            f"({len(words_x)} vs {len(words_y)})"
        )
    inds_replace = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [get_word_inds(x, i, tokenizer) for i in inds_replace]
    inds_target = [get_word_inds(y, i, tokenizer) for i in inds_replace]
    mapper = np.zeros((max_len, max_len), dtype=np.float32)
    i = j = 0
    cur = 0
    while i < max_len and j < max_len:
        if cur < len(inds_source) and len(inds_source[cur]) > 0 and inds_source[cur][0] == i:
            src, tgt = inds_source[cur], inds_target[cur]
            if len(src) == len(tgt):
                mapper[src, tgt] = 1
            else:
                ratio = 1.0 / len(tgt)
                for t in tgt:
                    mapper[src, t] = ratio
            cur += 1
            i += len(src)
            j += len(tgt)
        elif cur < len(inds_source):
            mapper[i, j] = 1
            i += 1
            j += 1
        else:
            mapper[j, j] = 1
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(prompts: Sequence[str], tokenizer,
                           max_len: int = MAX_NUM_WORDS) -> np.ndarray:
    return np.stack(
        [get_replacement_mapper_single(prompts[0], p, tokenizer, max_len) for p in prompts[1:]]
    )


def get_equalizer(text: str, word_select, values, tokenizer) -> np.ndarray:
    """(1, 77) per-token attention re-weighting vector."""
    if isinstance(word_select, (int, str)):
        word_select = (word_select,)
    eq = np.ones((1, MAX_NUM_WORDS), dtype=np.float32)
    for word, val in zip(word_select, values):
        inds = get_word_inds(text, word, tokenizer)
        eq[:, inds] = val
    return eq
