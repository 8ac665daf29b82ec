"""Driver of the batched sweep: ``pnpinversion_tpu_torch.runners.run_sweep``.

The window is one call of ``run_sweep(args, method, pipe, pending, logger)``
over the window's items, ``batch_per_device`` images a batched call, the
strips written by the sweep's own worker thread. The pipeline is the
program's ``SDPipeline.create`` of the configuration, in the mix's dtype, its
tokenizer the program's CLIP BPE tokenizer on the run's vocabulary, its
weights the benchmark's (loaded over the program's own draw). The warm-up is
one batch through the same call on a view of the pipeline at
``warmup_steps`` DDIM steps: the same shapes and kernels, fewer steps.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from perfbench import harness, weights
from perfbench.traffic import generator


class Driver:
    entry = "run_sweep"

    def __init__(self, ctx: dict):
        self.ctx = ctx
        self.mix = ctx["mix"]
        self.batch = self.mix["batch_per_device"]
        self.method = self.mix["method"]

    # ------------------------------------------------------------------ set-up
    def prepare(self) -> None:
        from pnpinversion_tpu_torch.pipeline import SDPipeline
        from pnpinversion_tpu_torch.utils.tokenizer import CLIPBPETokenizer

        ctx, mix = self.ctx, self.mix
        root = ctx["tmp"]
        self.vocab = generator.vocabulary(root, mix)
        self.sets = {}
        for salt, (name, n) in enumerate((("warmup", self.batch), ("window", ctx["items"]),
                                          ("profile", self.batch))):
            self.sets[name] = generator.generate(os.path.join(root, name), n, ctx["seed"],
                                                 salt, mix)
        dtype = harness.dtype_of(mix["dtype"])
        pipe = SDPipeline.create(harness.port_config(ctx["config"]), num_ddim_steps=mix["steps"],
                                 device=ctx["device"], dtype=dtype,
                                 tokenizer=CLIPBPETokenizer(self.vocab), quantize="none")
        sd = weights.make(ctx["config"], ctx["seed"], dtype, ctx["device"])
        for part, module in (("unet", pipe.unet), ("vae", pipe.vae), ("text", pipe.text_encoder)):
            module.load_state_dict(sd[part])
        del sd
        self.pipe = pipe
        self.probe = harness.UnetProbe(pipe.unet)
        self.vae_probe = harness.VaeProbe(pipe.vae)

    def warmup(self) -> None:
        from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

        view = dataclasses.replace(self.pipe, schedule=make_ddim_schedule(
            num_steps=self.mix["warmup_steps"]))
        self._run("warmup", view)

    def _args(self, name: str):
        from pnpinversion_tpu_torch.runners.run_sweep import sweep_argparser

        root = os.path.dirname(self.sets[name])
        return sweep_argparser().parse_args([
            "--method", self.method, "--batch_per_device", str(self.batch),
            "--data_path", self.sets[name], "--output_path", os.path.join(root, "output"),
            "--run_log", os.path.join(root, "run_log.jsonl"),
            "--num_ddim_steps", str(self.mix["steps"]), "--device", str(self.ctx["device"])])

    def _pending(self, name: str):
        from pnpinversion_tpu_torch.runners.run_sweep import pending_items
        from pnpinversion_tpu_torch.utils.observability import RunLogger

        args = self._args(name)
        logger = RunLogger(args.run_log)
        return args, logger, pending_items(args, self.method, logger)

    def _run(self, name: str, pipe=None) -> list:
        from pnpinversion_tpu_torch.runners.run_sweep import run_sweep

        args, logger, pending = self._pending(name)
        run_sweep(args, self.method, pipe or self.pipe, pending, logger)
        return pending

    # ------------------------------------------------------------------ window
    def arm(self, chunk: int, calls_per_chunk: int) -> None:
        """Capture every UNet call of the window's ``chunk``-th batch."""
        self.chunk = chunk
        self.window_args = self._pending("window")
        self.probe.reset(capture=range(chunk * calls_per_chunk, (chunk + 1) * calls_per_chunk))
        self.vae_probe.on = True

    def window(self) -> dict:
        from pnpinversion_tpu_torch.runners.run_sweep import run_sweep

        args, logger, pending = self.window_args
        run_sweep(args, self.method, self.pipe, pending, logger)
        self.vae_probe.on = False
        self.pending = pending
        return {"attempted": len(pending),
                "images": sum(os.path.exists(e["save_path"]) for e in pending)}

    def profiled_batch(self) -> int:
        """One more batch (the profile set), as the window runs it; returns
        its images."""
        self._run("profile")
        return self.batch

    # ------------------------------------------------------------------ check
    def check_inputs(self) -> dict:
        b = self.batch
        chunk = self.pending[self.chunk * b: (self.chunk + 1) * b]
        items = [{"source": e["item"].source_prompt, "target": e["item"].target_prompt,
                  "blend": e["item"].blended_word, "image": e["item"].image_path,
                  "mask": _rle(self.sets["window"], e["item"].key)} for e in chunk]
        return {"calls": self.probe.captured, "vae": self.vae_probe.chunk(self.chunk),
                "items": items, "n": b,
                "strips": [e["save_path"] for e in chunk], "vocab": self.vocab}

    def release(self) -> None:
        self.probe.remove()
        self.vae_probe.remove()
        del self.pipe, self.probe, self.vae_probe
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _rle(data: str, key: str):
    import json

    with open(os.path.join(data, "mapping_file.json")) as f:
        return json.load(f)[key]["mask"]
