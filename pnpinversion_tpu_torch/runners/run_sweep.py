"""The batched PIE-Bench sweep on one GPU: the one-device form of
``runners/run_sweep_sharded.py``.

    python -m pnpinversion_tpu_torch.runners.run_sweep --method directinversion+p2p \\
        --data_path D --output_path O [--batch_per_device 0] [--checkpoint_dir C] \\
        [--caption_file F] [--device cpu]

Items are grouped by the program they run (the P2P spec: replace or refine,
blend on or off), padded to the batch with the last image and edited
``--batch_per_device`` images per call through the port's ``Batched*``
classes; the padded slots are dropped. The outputs keep the runners'
4-panel strips and skip-existing contract (``--rerun_exist_images``), so a
sweep restarts where it stopped and ``evaluation.evaluate`` scores it. An
unreadable input is logged and dropped up front. ``--batch_per_device 0``
picks 4 on the card for the light P2P family (the JAX runner's probed
optimum) and 1 otherwise, and 1 on the CPU. The pipeline is bf16 on the
card and f32 on the CPU, as the JAX runner's. A strip is written on a worker
thread while the card edits the next batch. One process, one GPU; the
multi-process sweep, one process per GPU with the JAX runner's
``--n_devices``/``--num_processes``/``--process_id``/``--coordinator_address``
flags, is ``runners/run_sweep_sharded.py``, which runs these functions on
each process's slice.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from pnpinversion_tpu_torch.cli import check_args, profile_trace, save_strip, standard_argparser
from pnpinversion_tpu_torch.configs import IP2P, SD14, SD21
from pnpinversion_tpu_torch.control.p2p import make_p2p_control, stack_tensors
from pnpinversion_tpu_torch.data.pie_bench import PieBenchDataset, load_image
from pnpinversion_tpu_torch.parallel import agreement
from pnpinversion_tpu_torch.parallel.sweep import (
    BatchedBLD,
    BatchedDirectInversionP2P,
    BatchedEDICT,
    BatchedEditFriendly,
    BatchedInstruct,
    BatchedMasaCtrl,
    BatchedPix2PixZero,
    BatchedPnP,
    BatchedStyleDiffusion,
    group_items_by_spec,
    pad_batch,
)
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.utils.image import make_strip, txt_draw
from pnpinversion_tpu_torch.utils import observability
from pnpinversion_tpu_torch.utils.observability import RunLogger, span, spanned

METHODS = (["directinversion+p2p", "ddim+p2p", "negative-prompt-inversion+p2p",
            "null-text-inversion+p2p", "negative-prompt-inversion+proximal-guidance",
            "null-text-inversion+proximal-guidance", "directinversion+masactrl",
            "ddim+masactrl", "directinversion+pnp", "ddim+pnp", "edit-friendly-inversion+p2p",
            "blended-latent-diffusion", "edict+direct_forward", "edict+p2p",
            "instruct-pix2pix", "instruct-diffusion", "ddim+pix2pix-zero",
            "directinversion+pix2pix-zero", "stylediffusion+p2p"]
           + [f"directinversion+p2p_guidance_{a}_{b}"
              for a in ("0", "1", "25", "5", "75") for b in ("1", "5", "25", "75")]
           + ["ablation_directinversion_04+p2p", "ablation_directinversion_08+p2p",
              "ablation_directinversion_add-source+p2p",
              "ablation_directinversion_add-target+p2p", "ablation_null-latent-inversion+p2p",
              "ablation_null-text-inversion_single_branch+p2p"]
           + [f"ablation_directinversion_interval_{k}+p2p" for k in (2, 5, 10, 24, 49)]
           # the step-count ablations: plain directinversion+p2p at <k> steps
           + [f"ablation_directinversion_step_{k}+p2p" for k in (20, 100, 500)])

# reference output folders that differ from the method string
# (run_editing_stylediffusion.py keeps this typo)
FOLDERS = {"stylediffusion+p2p": "styleidffusion+p2p"}


def _pad(t: torch.Tensor, batch: int) -> torch.Tensor:
    """The leading axis padded to ``batch`` with its last element."""
    return torch.cat([t, t[-1:].expand((batch - t.shape[0],) + t.shape[1:])])


def _stack(chunk, batch: int):
    """The chunk's control tensors stacked, padded with the last item's."""
    per = [e["tensors"] for e in chunk]
    return stack_tensors(per + [per[-1]] * (batch - len(per)))


def _lanczos(path: str, size: int) -> np.ndarray:
    """RGB resized with Lanczos, no crop (the instruction and pix2pix-zero
    editors' loading)."""
    img = Image.open(path).convert("RGB")
    return np.array(img.resize((size, size), Image.Resampling.LANCZOS))


def _prompts(*fields):
    """texts(chunk, images) for ``_edit_chunks``: these fields of each item."""
    return lambda chunk, images: [getattr(e["item"], f) for e in chunk for f in fields]


class PipelinedSaver:
    """Writes a chunk's strips on a worker thread while the card edits the
    next chunk; ``flush`` waits for the last one (and raises its error).
    With ``write`` False it drops them (a tensor-parallel rank past tp
    index 0, whose edits its group's first rank writes). Every chunk's
    decoded panels go into the rank's record (``parallel/agreement.py``)
    first, written or not. Each strip's ``image_done`` event carries its
    chunk's index (``chunk``, the sweep's running count, ``chunks``): a
    chunk's strips land together, one batched call apart from the next
    chunk's. With ``profile_dir`` the sweep's first chunk is profiled there
    (``cli.profile_trace``), its strips written before the profile ends."""

    def __init__(self, size: int, logger: RunLogger, method: str, write: bool = True,
                 profile_dir: Optional[str] = None):
        self.size, self.logger, self.method, self.write = size, logger, method, write
        self.profile_dir = profile_dir
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None
        self.chunks = 0

    def push(self, chunk, images, recon, edit) -> None:
        index, self.chunks = self.chunks, self.chunks + 1
        agreement.digest("panels", recon, edit)
        if not self.write:
            return
        self.flush()
        self._pending = self._pool.submit(self._save, chunk, images, recon, edit, index,
                                          observability.tracing())

    def flush(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            with span("pnpi.sweep.saver_wait"):
                pending.result()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._pool.shutdown()

    def _save(self, chunk, images, recon, edit, index: int, traced: bool) -> None:
        with span("pnpi.sweep.write_strip", request=index, traced=traced, images=len(chunk)):
            for i, e in enumerate(chunk):
                item = e["item"]
                text = txt_draw(f"source prompt: {item.source_prompt}\n"
                                f"target prompt: {item.target_prompt}",
                                target_size=(self.size, self.size))
                save_strip(make_strip([text, images[i], recon[i], edit[i]]), e["save_path"])
                self.logger.log("image_done", key=item.key, method=self.method, chunk=index)
                print(f"saved {e['save_path']}", flush=True)


def _edit_chunks(pipe, saver: PipelinedSaver, items, batch: int, load, texts, edit) -> None:
    """Every sweep's loop: ``items`` ``batch`` at a time, each chunk inside a
    ``pnpi.sweep.batch`` span whose request id is its index in the sweep:
    its images loaded (``load(item)``, padded to ``batch`` with the last),
    its prompts encoded in one text-encoder call (``texts(chunk, images)``:
    each item's prompts in turn, as many each; (batch, rows, 77, D), padded),
    ``edit(chunk, images (batch, H, W, 3), cond)`` -> (recon, or None for
    the editors that have none, edit), and the panels handed to ``saver``."""
    for lo in range(0, len(items), batch):
        chunk = items[lo: lo + batch]
        index = saver.chunks
        profiled = saver.profile_dir if index == 0 else None
        with profile_trace(profiled):
            with span("pnpi.sweep.batch", request=index, index=index, images=len(chunk)):
                with span("pnpi.sweep.load_images"):
                    images = [load(e["item"]) for e in chunk]
                    imgs, _ = pad_batch(images, batch)
                with span("pnpi.sweep.encode_prompts"):
                    prompts = texts(chunk, images)
                    embs = pipe.encode_prompt(prompts)
                    cond = _pad(embs.reshape((len(chunk), len(prompts) // len(chunk))
                                             + embs.shape[1:]), batch)
                with span("pnpi.sweep.edit"):
                    recon, out = edit(chunk, imgs, cond)
                saver.push(chunk, images, np.zeros_like(out) if recon is None else recon, out)
            if profiled:  # the traced chunk's strips written, their span in the trace's file
                saver.flush()


def sweep_p2p(pipe, pending, batch, size, saver, method="directinversion+p2p", tp_group=None):
    from pnpinversion_tpu_torch.editors.p2p_editor import GUIDANCE_GRID

    sweep = BatchedDirectInversionP2P(pipe, tp_group=tp_group)
    with span("pnpi.sweep.prepare"):
        for e in pending:
            blended = e["item"].blended_word
            ctrl, e["tensors"] = make_p2p_control(
                [e["item"].source_prompt, e["item"].target_prompt], pipe.tokenizer,
                num_steps=pipe.schedule.num_steps, cross_replace_steps=0.4,
                self_replace_steps=0.6, is_replace_controller=False,
                blend_words=(((blended[0],), (blended[1],)) if blended else None),
                eq_params=({"words": (blended[1],), "values": (2,)} if blended else None),
                num_lb_slots=pipe.num_lb_slots, lb_res=pipe.lb_res,
                latent_size=pipe.latent_size, device=pipe.device)
            e["spec"] = ctrl.spec
        uncond = pipe.encode_prompt(["", ""])
    g = (GUIDANCE_GRID[method.split("_")[-1]]
         if method.startswith("directinversion+p2p_guidance_") else 7.5)
    # negative-prompt inversion: the source prompt's embedding is the
    # "uncond" of both rows (npi_interp 0, run_editing_p2p.py:335)
    npi = method.startswith("negative-prompt-inversion")
    for spec, group in group_items_by_spec(pending, lambda e: e["spec"]).items():
        def edit(chunk, imgs, cond, spec=spec):
            unc = cond[:, :1].expand(-1, 2, -1, -1) if npi else uncond
            return sweep.edit_batch(spec, imgs, cond, unc, g, _stack(chunk, batch),
                                    method=method)
        _edit_chunks(pipe, saver, group, batch, lambda it: load_image(it.image_path, size),
                     _prompts("source_prompt", "target_prompt"), edit)


def sweep_masactrl(pipe, pending, batch, size, saver, method, tp_group=None):
    sweep = BatchedMasaCtrl(pipe, tp_group=tp_group)
    _edit_chunks(pipe, saver, pending, batch, lambda it: load_image(it.image_path, size),
                 lambda chunk, _: [t for e in chunk for t in ("", e["item"].target_prompt)],
                 lambda chunk, imgs, cond: sweep.edit_batch(
                     method == "directinversion+masactrl", imgs, cond, 7.5))


def sweep_pnp(pipe, pending, batch, size, saver, method, tp_group=None):
    sweep = BatchedPnP(pipe, tp_group=tp_group)
    _edit_chunks(pipe, saver, pending, batch, lambda it: load_image(it.image_path, size),
                 _prompts("source_prompt", "target_prompt"),
                 lambda chunk, imgs, both: sweep.edit_batch(method, imgs, both[:, :1],
                                                            both[:, 1:], 7.5))


def sweep_ef(pipe, pending, batch, size, saver, tp_group=None):
    from pnpinversion_tpu_torch.editors.ef_editor import ef_control

    sweep = BatchedEditFriendly(pipe, tp_group=tp_group)
    with span("pnpi.sweep.prepare"):
        for e in pending:
            ctrl, e["tensors"] = ef_control(pipe, [e["item"].source_prompt,
                                                   e["item"].target_prompt],
                                            sweep.schedule.num_steps)
            e["spec"] = ctrl.spec
    for spec, group in group_items_by_spec(pending, lambda e: e["spec"]).items():
        def edit(chunk, imgs, cond, spec=spec):
            return sweep.edit_batch(spec, imgs, cond, 1.0, 7.5, _stack(chunk, batch))
        _edit_chunks(pipe, saver, group, batch, lambda it: load_image(it.image_path, size),
                     _prompts("source_prompt", "target_prompt"), edit)


def sweep_bld(pipe, pending, batch, size, saver, tp_group=None):
    from pnpinversion_tpu_torch.editors.bld_editor import latent_mask

    sweep = BatchedBLD(pipe, tp_group=tp_group)

    def edit(chunk, imgs, cond):
        masks, _ = pad_batch([latent_mask(e["item"].mask, pipe.latent_size) for e in chunk],
                             batch)
        return None, sweep.edit_batch(imgs, masks, cond)
    # BLD resizes without the crop (run_editing_blended_latent_diffusion.py:58-60)
    _edit_chunks(pipe, saver, pending, batch,
                 lambda it: np.array(Image.open(it.image_path).resize(
                     (size, size), Image.BILINEAR))[:, :, :3],
                 _prompts("target_prompt"), edit)


def sweep_edict(pipe, pending, batch, size, saver, method, tp_group=None):
    from pnpinversion_tpu_torch.control.edict_p2p import make_edict_p2p_tensors

    sweep = BatchedEDICT(pipe, precision="df64", tp_group=tp_group)
    with span("pnpi.sweep.prepare"):
        for e in pending:
            e["tensors"] = make_edict_p2p_tensors(e["item"].source_prompt,
                                                  e["item"].target_prompt, pipe.tokenizer,
                                                  pipe.config.text.max_length,
                                                  device=pipe.device)

    def edit(chunk, imgs, both):
        tensors = _stack(chunk, batch) if method == "edict+p2p" else None
        return sweep.edit_batch(method, imgs, both[:, :1], both[:, 1:], tensors)
    _edit_chunks(pipe, saver, pending, batch, lambda it: load_image(it.image_path, size),
                 _prompts("source_prompt", "target_prompt"), edit)


def sweep_instruct(pipe, pending, batch, size, saver, method, tp_group=None):
    sweep = BatchedInstruct(pipe, tp_group=tp_group)
    # the instruction editors resize with Lanczos, no crop
    # (run_editing_instructpix2pix.py:115-118)
    _edit_chunks(pipe, saver, pending, batch, lambda it: _lanczos(it.image_path, size),
                 _prompts("editing_instruction"),
                 lambda chunk, imgs, cond: (None, sweep.edit_batch(method, imgs, cond)))


def sweep_p2z(pipe, pending, batch, size, saver, method, args, tp_group=None):
    from pnpinversion_tpu_torch.runners.run_editing_pix2pix_zero import (
        load_captioner,
        load_captions,
    )

    captions = load_captions(args.caption_file)
    captioner = load_captioner(args.checkpoint_dir, pipe.device)
    sweep = BatchedPix2PixZero(pipe, tp_group=tp_group)

    def texts(chunk, images):
        caps = [captions.get(e["item"].key) for e in chunk]
        missing = [i for i, c in enumerate(caps) if c is None]
        if missing:
            if captioner is None:
                raise ValueError("pix2pix-zero needs captions: pass --caption_file or BLIP "
                                 "weights under --checkpoint_dir")
            for i, c in zip(missing, captioner.caption_batch(np.stack([images[i]
                                                                       for i in missing]))):
                caps[i] = c
        return [t for e, cap in zip(chunk, caps)
                for t in (cap, e["item"].source_prompt, e["item"].target_prompt)]
    _edit_chunks(pipe, saver, pending, batch, lambda it: _lanczos(it.image_path, size), texts,
                 lambda chunk, imgs, embs: sweep.edit_batch(method, imgs, embs[:, 0:1],
                                                            embs[:, 2:3] - embs[:, 1:2]))


def sweep_stylediffusion(pipe, pending, batch, size, saver, tp_group=None):
    from pnpinversion_tpu_torch.editors.stylediffusion_editor import stylediffusion_p2p

    # 100 inner steps, as the reference runs it
    sweep = BatchedStyleDiffusion(pipe, tp_group=tp_group)
    with span("pnpi.sweep.prepare"):
        for e in pending:
            # the reference passes no blend words and no equalizer
            # (run_editing_stylediffusion.py:249-258)
            ctrl, e["tensors"] = stylediffusion_p2p(pipe, [e["item"].source_prompt,
                                                           e["item"].target_prompt])
            e["spec"] = ctrl.spec
    for spec, group in group_items_by_spec(pending, lambda e: e["spec"]).items():
        def edit(chunk, imgs, both, spec=spec):
            return sweep.edit_batch(spec, imgs, both[:, :1], both, _stack(chunk, batch), 7.5)
        _edit_chunks(pipe, saver, group, batch, lambda it: load_image(it.image_path, size),
                     _prompts("source_prompt", "target_prompt"), edit)


def auto_batch(method: str, device: torch.device) -> int:
    """4 images per call on the card for the light P2P family (the JAX
    runner's probed optimum), 1 for the heavier programs and on the CPU."""
    light = (method.startswith("directinversion+p2p")
             or method in ("ddim+p2p", "negative-prompt-inversion+p2p")
             or BatchedDirectInversionP2P.step_ablation_steps(method) is not None)
    return 4 if light and device.type == "cuda" else 1


def sweep_items(args) -> list:
    """The mapping file's items in the chosen categories, in its order."""
    dataset = PieBenchDataset(args.data_path, mapping_file=args.mapping_file)
    return list(dataset.items(args.edit_category_list))


@spanned("pnpi.sweep.prepare")
def pending_items(args, method: str, logger: RunLogger, items=None) -> list:
    """The items (``sweep_items`` unless given) whose strip is not written
    yet, readable ones only: an unreadable input is logged and dropped (it
    would fail every restart at the same chunk)."""
    pending = []
    for item in sweep_items(args) if items is None else items:
        rel = item.rel_output_path(os.path.join(args.data_path, "annotation_images"))
        save_path = os.path.join(args.output_path, FOLDERS.get(method, method),
                                 "annotation_images", rel)
        if os.path.exists(save_path) and not args.rerun_exist_images:
            logger.log("image_skip", key=item.key, method=method)
            continue
        try:
            Image.open(item.image_path).verify()
        except Exception as exc:  # noqa: BLE001 - log and drop this one item
            logger.log("image_error", key=item.key, method=method,
                       error=f"unreadable input: {exc!r}"[:300])
            print(f"skipping unreadable input [{item.image_path}]: {exc!r}", flush=True)
            continue
        pending.append({"item": item, "save_path": save_path})
    return pending


def sweep_argparser():
    """The runners' flags plus the sweep's own."""
    parser = standard_argparser(["directinversion+p2p"])
    parser.add_argument("--caption_file", type=str, default=None,
                        help="pix2pix-zero: JSON {image key: caption} instead of BLIP")
    parser.add_argument("--method", choices=METHODS, default="directinversion+p2p")
    parser.add_argument("--batch_per_device", type=int, default=0,
                        help="images per call; 0 = auto (4 on the card for the light P2P "
                             "family, 1 otherwise and on the CPU)")
    return parser


def sweep_pipeline(args, method: str, device=None) -> SDPipeline:
    """The method's pipeline: BLD runs SD2.1-base
    (run_editing_blended_latent_diffusion.py:43), the instruction editors the
    8-channel UNet, everything else SD1.4; bf16 on the card, f32 on the CPU;
    the step-count ablations at their own steps; w8 with ``--quant w8``."""
    config = (SD21 if method == "blended-latent-diffusion"
              else IP2P if method.startswith("instruct") else SD14)
    steps = BatchedDirectInversionP2P.step_ablation_steps(method) or args.num_ddim_steps
    return SDPipeline.create(config, num_ddim_steps=steps, checkpoint_dir=args.checkpoint_dir,
                             device=args.device if device is None else device,
                             quantize=args.quant)


def run_sweep(args, method: str, pipe, pending, logger: RunLogger, tp_group=None,
              write: bool = True) -> int:
    """Edits ``pending`` with the method's batched class, ``--batch_per_device``
    images a call (auto when 0), the strips written on a worker thread (none
    without ``write``); the pipeline split over ``tp_group`` where one is
    given. Returns the batch."""
    batch = args.batch_per_device if args.batch_per_device > 0 else auto_batch(method,
                                                                               pipe.device)
    size = pipe.config.image_size
    saver = PipelinedSaver(size, logger, method, write, getattr(args, "profile_dir", None))
    common = (pipe, pending, batch, size, saver)
    try:
        if BatchedDirectInversionP2P.supports(method):
            sweep_p2p(*common, method, tp_group)
        elif method.endswith("masactrl"):
            sweep_masactrl(*common, method, tp_group)
        elif method == "edit-friendly-inversion+p2p":
            sweep_ef(*common, tp_group)
        elif method == "blended-latent-diffusion":
            sweep_bld(*common, tp_group)
        elif method.startswith("edict"):
            sweep_edict(*common, method, tp_group)
        elif method.startswith("instruct"):
            sweep_instruct(*common, method, tp_group)
        elif method.endswith("pix2pix-zero"):
            sweep_p2z(*common, method, args, tp_group)
        elif method == "stylediffusion+p2p":
            sweep_stylediffusion(*common, tp_group)
        else:
            sweep_pnp(*common, method, tp_group)
    finally:
        saver.close()
    return batch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {"images": edited, "batch": images per call}."""
    args = sweep_argparser().parse_args(argv)
    check_args(args)
    method = args.method
    pipe = sweep_pipeline(args, method)
    logger = RunLogger(args.run_log)
    pending = pending_items(args, method, logger)
    if not pending:
        print("nothing to do", flush=True)
        return {"images": 0, "batch": 0}
    batch = run_sweep(args, method, pipe, pending, logger)
    logger.log("sweep_done", images_total=len(pending), method=method)
    print(json.dumps({"sweep_done": len(pending), "batch": batch}), flush=True)
    return {"images": len(pending), "batch": batch}


if __name__ == "__main__":
    main()
