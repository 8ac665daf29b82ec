"""What every cell shares: finding a cell's files by name, the environment of
a run, the benchmark's own spans around the UNet's calls, the program's
configuration from the benchmark's file, and the reference built for the
check.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
(``configs/<config>.json``) and a traffic mix (``mixes/<traffic>.json``); the
mix names its driver (``drivers/<driver>.py``) and its method's family
(``reference/methods/<family>.py``: the call structure, the reference's side
of the check, the frozen count); the cell's frozen work and its
check's limits are ``work/<cell>.json`` and ``limits/<cell>.json``; each
per-layer metric is read by ``metrics/<metric>.py``. Nothing here names a
cell: a new one is new files and new entries.
"""
from __future__ import annotations

import importlib.util
import json
import os
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pnpinversion_tpu")


def setup_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(ROOT, "build", "perfbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots and dashes)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + f"{kind}_{name}".replace("/", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_METHODS: dict = {}


def method(mix: dict):
    """The mix's method: ``reference/methods/<family>.py`` (``calls_per_chunk``,
    ``outputs``, ``work``)."""
    family = mix["family"]
    if family not in _METHODS:
        _METHODS[family] = load_module("reference/methods", family)
    return _METHODS[family]


def load_cell(name: str, bench: Optional[dict] = None) -> dict:
    """Everything a run of cell ``name`` reads, found by name."""
    bench = bench or json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    mix = _json("mixes", f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in moved
                 and name in m.get("workloads", [name])]
    out = {"name": name, "cell": cell, "config": config, "mix": mix, "end_to_end": e2e,
           "per_layer": per_layer, "driver": mix["driver"]}
    for kind in ("work", "limits"):
        path = os.path.join(HERE, kind, f"{name}.json")
        out[kind] = _json(kind, f"{name}.json") if os.path.exists(path) else None
    return out


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def port_config(config: dict):
    """The program's ``StableDiffusionConfig`` of a configuration file."""
    from pnpinversion_tpu_torch.configs import (
        CLIPTextConfig,
        StableDiffusionConfig,
        UNetConfig,
        VAEConfig,
    )

    u, v, t = config["unet"], config["vae"], config["text_encoder"]
    chs = tuple(u["block_out_channels"])
    heads = u["attention_head_dim"]
    if isinstance(heads, list):
        widths = {c // h for c, h in zip(chs, heads)}
        if len(widths) != 1:
            raise ValueError(f"head widths {widths} differ by level")
        head_kw = {"head_dim": widths.pop()}
    else:
        head_kw = {"num_heads": heads}
    unet = UNetConfig(in_channels=u["in_channels"], out_channels=u["out_channels"],
                      sample_size=u["sample_size"], block_out_channels=chs,
                      layers_per_block=u["layers_per_block"],
                      cross_attention=tuple(b.startswith("CrossAttn")
                                            for b in u["down_block_types"]),
                      context_dim=u["cross_attention_dim"], norm_groups=u["norm_num_groups"],
                      flip_sin_to_cos=u["flip_sin_to_cos"], freq_shift=u["freq_shift"],
                      **head_kw)
    vae = VAEConfig(in_channels=v["in_channels"], latent_channels=v["latent_channels"],
                    block_out_channels=tuple(v["block_out_channels"]),
                    layers_per_block=v["layers_per_block"], norm_groups=v["norm_num_groups"],
                    sample_size=v["sample_size"], scaling_factor=v["scaling_factor"])
    text = CLIPTextConfig(vocab_size=t["vocab_size"], width=t["hidden_size"],
                          layers=t["num_hidden_layers"], heads=t["num_attention_heads"],
                          max_length=t["max_position_embeddings"], activation=t["hidden_act"])
    return StableDiffusionConfig(unet=unet, vae=vae, text=text, name=config.get("name", "sd"))


def dtype_of(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class UnetProbe:
    """The benchmark's spans around the program's UNet calls, by forward pre-
    and post-hooks: calls, rows and host seconds per call; the inputs and
    outputs of the calls in ``capture`` (a range of call indices); inside a
    profile, a ``perfbench.unet_call`` span per call."""

    def __init__(self, unet):
        self.reset()
        self._handles = [unet.register_forward_pre_hook(self._pre, with_kwargs=True),
                         unet.register_forward_hook(self._post, with_kwargs=True)]

    def reset(self, capture: range = range(0), spans: bool = False) -> None:
        self.calls, self.rows, self.unet_s = 0, 0, 0.0
        self.capture, self.captured, self.spans = capture, [], spans
        self._open = None

    def _pre(self, module, args, kwargs):
        x, t = args[0], args[1]
        rec = None
        if self.spans:
            import torch

            rec = torch.profiler.record_function("perfbench.unet_call")
            rec.__enter__()
        cap = None
        if self.calls in self.capture:
            cap = {"x": x.detach().clone(), "t": t}
        self._open = (time.perf_counter(), rec, cap)
        self.rows += x.shape[0]

    def _post(self, module, args, kwargs, out):
        t0, rec, cap = self._open
        if cap is not None:
            cap["eps"] = out[0].detach().clone()
            self.captured.append(cap)
        if rec is not None:
            rec.__exit__(None, None, None)
        self.unet_s += time.perf_counter() - t0
        self.calls += 1

    def summary(self) -> dict:
        return {"calls": self.calls, "rows": self.rows, "unet_s": self.unet_s}

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


class VaeProbe:
    """The VAE's stages in the window, by hooks on its own layers: the
    encoder's output (``quant_conv``: posterior moments), the decoder's input
    (``post_quant_conv``'s, the unscaled latents) and output (``conv_out``'s,
    before the clamp); one entry a call, in order."""

    def __init__(self, vae):
        self.on = False
        self.enc, self.dec_in, self.dec_out = [], [], []
        grab = lambda store: lambda m, a, out: store.append(out.detach().clone()) if self.on else None  # noqa: E731
        self._handles = [
            vae.quant_conv.register_forward_hook(grab(self.enc)),
            vae.post_quant_conv.register_forward_pre_hook(
                lambda m, a: self.dec_in.append(a[0].detach().clone()) if self.on else None),
            vae.decoder.conv_out.register_forward_hook(grab(self.dec_out))]

    def chunk(self, k: int) -> dict:
        if not (len(self.enc) > k and len(self.dec_in) > k and len(self.dec_out) > k):
            raise ValueError(f"VAE stages for chunk {k}: {len(self.enc)} encodes, "
                             f"{len(self.dec_in)} decodes")
        return {"enc": self.enc[k], "dec_in": self.dec_in[k], "dec_out": self.dec_out[k]}

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


def build_reference(config: dict, mix: dict, seed: int, vocab_dir: str, device):
    """The reference of the check, on ``device``: its networks in f32 on the
    run's weights made again from the seed (in the mix's dtype, then f32)."""
    import torch

    from perfbench import weights
    from perfbench.reference import check, diffusion, models, text

    models.set_precision("f32")
    sd = weights.make(config, seed, dtype_of(mix["dtype"]), device)
    nets = models.build(config, "meta")
    for part, m in nets.items():
        m.to_empty(device=device)
        m.load_state_dict({k: v.float() for k, v in sd[part].items()})
        m.eval().requires_grad_(False)
    del sd
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    sched = diffusion.make_schedule(mix["scheduler"], mix["steps"])
    return check.Reference(nets, text.Tokenizer(vocab_dir), sched,
                           config["vae"]["sample_size"], device)
