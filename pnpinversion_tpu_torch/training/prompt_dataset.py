"""InstructPix2Pix prompt-dataset generation (the GPT-3 text stage).

The port's own copy of ``pnpinversion_tpu/training/prompt_dataset.py``, the
counterpart of ``models/instructpix2pix/dataset_creation/generate_txt_dataset.py`` (:15-17
wire format, :20-54 completion+validation loop, :57-102 resume/dedup/
partition driver) and ``prepare_for_gpt.py`` (:7-18 fine-tune record
transform). The reference prompts a *fine-tuned GPT-3* — an external paid
API with no local equivalent, unreachable offline — so the
completion backend here is pluggable:

- ``template_complete``: a deterministic, fully offline rule-based stand-in
  that emits well-formed ``edit %% output`` completions from a caption. It
  exists so the whole pipeline (prompts -> run_dataset_creation ->
  run_training_instructpix2pix) is runnable out of the box; it is NOT a
  language model and its edits are only as diverse as its templates.
- any callable ``complete_fn(prompt: str) -> Optional[str]`` — e.g. a thin
  wrapper over a hosted LLM completion endpoint. The driver loop, wire
  format, validation, resume, dedup, and partition semantics are identical
  either way.

Output records are ``{"caption", "edit", "output"}`` (+ optional ``url``)
— the same .jsonl schema the released 454k-prompt dataset ships as and the
schema ``training.dataset_creation.load_prompts`` consumes.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Wire format of the fine-tuned completion model
# (generate_txt_dataset.py:15-17): the prompt is `caption\n##\n`, the
# completion is `edit\n%%\noutput\nEND`.
DELIMITER_0 = "\n##\n"
DELIMITER_1 = "\n%%\n"
STOP = "\nEND"


def prepare_for_gpt(records: Iterable[Dict[str, str]]) -> List[Dict[str, str]]:
    """Human-written {input, edit, output} examples -> fine-tune records.

    Parity with prepare_for_gpt.py:13-16: the prompt is the input caption
    plus DELIMITER_0; the completion is edit + DELIMITER_1 + output + STOP.
    """
    out = []
    for r in records:
        out.append({
            "prompt": f"{r['input']}{DELIMITER_0}",
            "completion": f"{r['edit']}{DELIMITER_1}{r['output']}{STOP}",
        })
    return out


def _normalize(caption: str) -> str:
    # generate_txt_dataset.py:53 — edited caption must differ from the
    # source modulo trailing punctuation and case
    return caption.strip().strip(".!?").lower()


def parse_completion(caption: str, text: Optional[str]) -> Optional[Tuple[str, str]]:
    """Validate one raw completion -> (edit, output) or None.

    Mirrors generate_txt_dataset.py:47-54: must split into exactly two
    parts on DELIMITER_1 and the edited caption must not equal the source.
    (A STOP suffix, if the backend did not strip it, is removed here.)
    """
    if text is None:
        return None
    if text.endswith(STOP):
        text = text[: -len(STOP)]
    parts = text.split(DELIMITER_1)
    if len(parts) != 2:
        return None
    edit, output = parts
    if _normalize(caption) == _normalize(output):
        return None
    return edit, output


# ---------------------------------------------------------------------------
# Offline stand-in backend

_TEMPLATES: Sequence[Tuple[str, str]] = (
    ("make it look like a watercolor painting", "a watercolor painting of {}"),
    ("turn it into a pencil sketch", "a pencil sketch of {}"),
    ("make it snowy", "{} in the snow"),
    ("add a sunset in the background", "{} at sunset"),
    ("make it look like a photograph taken at night", "{} at night"),
    ("turn it into a stained glass window", "a stained glass window of {}"),
    ("make it autumn", "{} in autumn"),
    ("convert it to an oil painting", "an oil painting of {}"),
    ("put it underwater", "{} underwater"),
    ("make it foggy", "{} on a foggy day"),
)


def template_complete(prompt: str, index: int = 0) -> str:
    """Deterministic offline completion in the GPT-3 wire format.

    ``prompt`` is ``caption + DELIMITER_0`` (as the driver sends it);
    ``index`` selects a template so repeated calls over a caption list give
    varied edits without any randomness (reproducible CI).
    """
    caption = prompt[: -len(DELIMITER_0)] if prompt.endswith(DELIMITER_0) else prompt
    edit, out_fmt = _TEMPLATES[index % len(_TEMPLATES)]
    return f"{edit}{DELIMITER_1}{out_fmt.format(caption.strip().rstrip('.!?'))}{STOP}"


# ---------------------------------------------------------------------------
# Driver loop

def partition_captions(n_captions: int, num_partitions: int, partition: int,
                       seed: int) -> np.ndarray:
    """Shuffled np.array_split partition (generate_txt_dataset.py:64-66)."""
    rng = np.random.RandomState(seed)
    return np.array_split(rng.permutation(n_captions), num_partitions)[partition]


def generate_prompt_dataset(
    captions: Sequence[str],
    complete_fn: Callable[[str], Optional[str]],
    output_path: str,
    num_samples: int,
    urls: Optional[Sequence[str]] = None,
    moderation_fn: Optional[Callable[[str], bool]] = None,
) -> int:
    """Append validated {caption, edit, output[, url]} records to a .jsonl.

    Resume/dedup semantics of generate_txt_dataset.py:73-101: existing
    records in ``output_path`` count toward ``num_samples`` and their
    captions/urls are never regenerated. ``moderation_fn(text) -> flagged``
    drops a caption before completion (the reference calls the hosted
    moderation endpoint; offline runs pass None). Returns the total record
    count in the file.
    """
    caption_set, url_set = set(), set()
    count = 0
    if os.path.exists(output_path):
        with open(output_path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec["caption"] not in caption_set and rec.get("url") not in url_set:
                    caption_set.add(rec["caption"])
                    if rec.get("url") is not None:
                        url_set.add(rec["url"])
                    count += 1

    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "a") as fp:
        for i, caption in enumerate(captions):
            if count >= num_samples:
                break
            url = urls[i] if urls is not None else None
            if caption in caption_set or (url is not None and url in url_set):
                continue
            if moderation_fn is not None and moderation_fn(caption):
                continue
            parsed = parse_completion(caption, complete_fn(caption + DELIMITER_0))
            if parsed is None:
                continue
            edit, output = parsed
            if moderation_fn is not None and (moderation_fn(edit) or moderation_fn(output)):
                continue
            rec = dict(caption=caption, edit=edit, output=output)
            if url is not None:
                rec["url"] = url
            fp.write(json.dumps(rec) + "\n")
            count += 1
            caption_set.add(caption)
            if url is not None:
                url_set.add(url)
    return count
