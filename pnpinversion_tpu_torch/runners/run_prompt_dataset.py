"""Generate the InstructPix2Pix prompt dataset (the text stage): the port's
counterpart of ``runners/run_prompt_dataset.py``.

    python -m pnpinversion_tpu_torch.runners.run_prompt_dataset generate \\
        --captions_file captions.txt --output_path prompts.jsonl
    python -m pnpinversion_tpu_torch.runners.run_prompt_dataset prepare-for-gpt \\
        --input_path human_examples.jsonl --output_path finetune.jsonl

The completion backend is ``template`` (deterministic and offline,
``training.prompt_dataset.template_complete``). A hosted language model is
a callable the user hands to ``generate_prompt_dataset(complete_fn=...)``
in Python; this entry point reaches no network. Output records are
{"caption", "edit", "output"}, what ``run_dataset_creation`` consumes. It
runs on the host only (no device).
"""
from __future__ import annotations

import argparse
import itertools
import json
from typing import Optional, Sequence

from pnpinversion_tpu_torch.training import prompt_dataset as pd


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd")
    g = sub.add_parser("generate", help="captions -> prompt dataset")
    g.add_argument("--captions_file", required=True,
                   help='one caption per line (.txt) or .jsonl with a "caption"/"TEXT" field '
                        '(+ optional "url"/"URL")')
    g.add_argument("--output_path", required=True)
    g.add_argument("--num_samples", type=int, default=10000)
    g.add_argument("--num_partitions", type=int, default=1)
    g.add_argument("--partition", type=int, default=0)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--backend", default="template", choices=["template"])
    f = sub.add_parser("prepare-for-gpt",
                       help="human {input,edit,output} examples -> fine-tune "
                            "{prompt,completion} records")
    f.add_argument("--input_path", required=True)
    f.add_argument("--output_path", required=True)
    return p


def load_captions(path: str):
    """(captions, urls or None) from a .txt (one a line) or a .jsonl file."""
    captions, urls = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                rec = json.loads(line)
                captions.append(rec.get("caption") or rec.get("TEXT"))
                urls.append(rec.get("url") or rec.get("URL"))
            else:
                captions.append(line)
                urls.append(None)
    return captions, (None if all(u is None for u in urls) else urls)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "prepare-for-gpt":
        with open(args.input_path) as f:
            records = [json.loads(line) for line in f if line.strip()]
        out = pd.prepare_for_gpt(records)
        with open(args.output_path, "w") as f:
            for rec in out:
                f.write(json.dumps(rec) + "\n")
        print(f"wrote {len(out)} fine-tune records -> {args.output_path}")
        return len(out)
    if args.cmd != "generate":
        parser.error("choose a subcommand: generate | prepare-for-gpt")

    captions, urls = load_captions(args.captions_file)
    idx = pd.partition_captions(len(captions), args.num_partitions, args.partition, args.seed)
    captions = [captions[i] for i in idx]
    urls = [urls[i] for i in idx] if urls is not None else None
    calls = itertools.count()

    def complete_fn(prompt: str) -> str:
        return pd.template_complete(prompt, next(calls))

    n = pd.generate_prompt_dataset(captions, complete_fn, args.output_path, args.num_samples,
                                   urls=urls)
    print(f"{n} prompt records in {args.output_path}")
    return n


if __name__ == "__main__":
    main()
