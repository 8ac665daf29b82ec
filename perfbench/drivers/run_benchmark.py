"""Driver of the per-image runner: ``pnpinversion_tpu_torch.cli.run_benchmark``
with ``edit_fn`` calling ``P2PEditor(pipe)(method, image_path=...,
**run_editing_p2p.edit_kwargs(item))`` as ``runners/run_editing_p2p.py::main``
does. The pipeline is ``SDPipeline.create`` as ``cli.make_pipeline`` calls it
(the mix's dtype; full f32 on the card, TF32 off), with the program's CLIP BPE
tokenizer on the run's vocabulary and the benchmark's weights. Each image is
one chunk; the warm-up is one image at ``warmup_steps`` DDIM steps.
"""
from __future__ import annotations

import dataclasses
import os

from perfbench.drivers.run_sweep import Driver as SweepDriver
from perfbench.drivers.run_sweep import _rle


class Driver(SweepDriver):
    entry = "run_benchmark"

    def _args(self, name: str):
        from pnpinversion_tpu_torch.cli import standard_argparser

        root = os.path.dirname(self.sets[name])
        return standard_argparser([self.method]).parse_args([
            "--data_path", self.sets[name], "--output_path", os.path.join(root, "output"),
            "--run_log", os.path.join(root, "run_log.jsonl"),
            "--num_ddim_steps", str(self.mix["steps"]), "--device", str(self.ctx["device"])])

    def _run(self, name: str, pipe=None) -> None:
        from pnpinversion_tpu_torch.cli import run_benchmark
        from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
        from pnpinversion_tpu_torch.runners import run_editing_p2p as runner

        editor = P2PEditor(pipe or self.pipe)

        def edit_fn(edit_method, item):
            return editor(edit_method, image_path=item.image_path, **runner.edit_kwargs(item))

        run_benchmark(self._args(name), edit_fn, runner.IMAGE_SAVE_PATHS)

    def warmup(self) -> None:
        from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

        self._run("warmup", dataclasses.replace(self.pipe, schedule=make_ddim_schedule(
            num_steps=self.mix["warmup_steps"])))

    def arm(self, chunk: int, calls_per_chunk: int) -> None:
        from pnpinversion_tpu_torch.data.pie_bench import PieBenchDataset

        self.chunk = chunk
        args = self._args("window")
        items = list(PieBenchDataset(args.data_path).items(args.edit_category_list))
        self.saved = [os.path.join(args.output_path, self.method, "annotation_images",
                                   it.rel_output_path(os.path.join(args.data_path,
                                                                   "annotation_images")))
                      for it in items]
        self.items = items
        self.probe.reset(capture=range(chunk * calls_per_chunk, (chunk + 1) * calls_per_chunk))
        self.vae_probe.on = True

    def window(self) -> dict:
        self._run("window")
        self.vae_probe.on = False
        return {"attempted": len(self.items),
                "images": sum(os.path.exists(p) for p in self.saved)}

    def check_inputs(self) -> dict:
        it = self.items[self.chunk]
        item = {"source": it.source_prompt, "target": it.target_prompt,
                "blend": it.blended_word, "image": it.image_path,
                "mask": _rle(self.sets["window"], it.key)}
        return {"calls": self.probe.captured, "vae": self.vae_probe.chunk(self.chunk),
                "items": [item], "n": 1,
                "strips": [self.saved[self.chunk]], "vocab": self.vocab}
