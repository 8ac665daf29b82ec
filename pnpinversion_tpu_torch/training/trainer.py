"""Edit-conditioned latent-diffusion training on one GPU or data parallel over
several (port of ``pnpinversion_tpu/training/trainer.py``).

The objective is the JAX trainer's (``ddpm_edit.py`` semantics):

- z = a sample of the VAE posterior of the edited image times the scaling
  factor; the image conditioning is the posterior **mode** of the source
  image, unscaled; the prompt and the null prompt are encoded in one text
  call;
- per-item classifier-free dropout from uniforms r (``cond_dropout_masks``);
- ``q_sample`` in f32, cast to the compute dtype; the UNet on
  ``cat([x_noisy, img_cond], channel)``; the eps MSE per item over its
  pixels in f32, then the batch mean.

bf16 compute runs on f32 master weights: the UNet's layers cast each f32
weight to the activation's dtype, so the gradients come back to the masters
in f32, as the JAX trainer's ``cast(params)`` gives them. The VAE and the
text encoder are frozen.

A step sums the microbatches' losses and f32 gradients and divides both by
the number of microbatches (the JAX ``lax.scan``), takes the global gradient
norm, applies optax's ``chain(clip_by_global_norm, adamw)`` in optax's order
of operations (``adamw_update_``), then the EMA with LitEMA's warm-up.

The draws (the posterior noise, the timesteps, the q_sample noise and the
dropout uniforms) come from a ``torch.Generator``; the JAX trainer splits
them from a key it folds the step into. The port seeds one generator per
optimizer step from (seed, step) (``step_generator``), so a resumed run
draws what an uninterrupted one draws without saving a generator's state.
The loss also takes the draws explicitly, so tests can hand it the very
values JAX draws.

Data parallel over a ``torch.distributed`` group (``group=``, one process
per GPU; the JAX trainer's ``dp`` mesh axis): ``batch_per_step`` is the
global batch, and each of the W ranks takes its B/W rows of every
microbatch (its own data stream). Every rank draws the *global* batch's
draws from the step's generator and keeps its rows, so a W-rank step is the
one-rank step on the same global batch. The rows' gradient sums are
all-reduced in flat buckets (``multihost.all_reduce_``) and divided into the
global mean; the grad norm and the clip are taken on the reduced gradients.
With ``TrainConfig.zero`` (ZeRO-1, the JAX ``zero_shardings``) each rank
keeps Adam's moments for its block of each tensor only (``zero_partition``:
the largest axis W divides, else the whole tensor on every rank), updates
that block, and every rank's blocks are gathered into every rank's
parameters (a broadcast from each rank); the EMA stays whole on every rank. The learning rate scales with
n_dp = W.

With ``tp_group`` (the tensor-parallel axis, ``parallel/tensor_parallel.py``:
``group`` is then this rank's dp group) the UNet's layers are split by output
columns over the tp group, as the JAX trainer's ``param_shardings``: the
parameters, the EMA and Adam's moments hold this rank's column blocks, ZeRO
partitions those local tensors over dp, the gradients are all-reduced over
dp only (the tp ranks of a group take the same rows and compute the same
replicated gradients), the grad norm sums the split blocks' squares over tp,
and the learning rate scales with n_dp.

Checkpoints are ``torch.save`` files ``<dir>/step_<n:08d>.pt`` of the whole
state at any (dp, tp) (the blocks gathered; rank 0 writes), and a checkpoint
of any (dp, tp) restores at any other. Reading the JAX trainer's orbax
checkpoints is not ported (``convert.train_state_from_jax`` carries a live
JAX state across).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from pnpinversion_tpu_torch.configs import StableDiffusionConfig
from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
from pnpinversion_tpu_torch.models.unet import UNet
from pnpinversion_tpu_torch.models.vae import VAE
from pnpinversion_tpu_torch.ops.quant import is_quantized
from pnpinversion_tpu_torch.parallel import multihost
from pnpinversion_tpu_torch.parallel.tensor_parallel import shard_columns_, tp_axes
from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

F32 = np.float32
Draws = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters, defaults = configs/train.yaml + torch AdamW (the JAX
    ``TrainConfig``)."""

    base_lr: float = 1e-4
    scale_lr: bool = True            # lr = accum * n_dp * batch * base_lr
    warmup_steps: int = 0
    f_start: float = 1e-6            # LambdaLinearScheduler f_start
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_grad: float = 0.0
    accum: int = 4                   # accumulate_grad_batches
    uncond_prob: float = 0.05
    ema_decay: float = 0.9999        # LitEMA default
    zero: bool = True                # shard Adam's moments over the ranks (ZeRO-1)
    dtype: torch.dtype = torch.bfloat16  # compute dtype; master weights stay f32
    remat: bool = False              # checkpoint the UNet forward: its activations
    # are recomputed in the backward (the flash forward runs twice)


def lambda_linear_lr(cfg: TrainConfig, n_dp: int, batch_per_step: int
                     ) -> Callable[[float], float]:
    """LambdaLinearScheduler with the shipped near-infinite cycle: linear
    f_start -> 1 over the warm-up, then constant; in f32 as the JAX schedule
    computes it."""
    lr = cfg.base_lr
    if cfg.scale_lr:
        lr = cfg.accum * n_dp * batch_per_step * cfg.base_lr

    def sched(step) -> float:
        if cfg.warmup_steps <= 0:
            return float(F32(lr))
        f = F32(cfg.f_start) + F32(1.0 - cfg.f_start) * np.minimum(
            F32(step) / F32(cfg.warmup_steps), F32(1.0))
        return float(F32(lr) * f)

    return sched


def extend_conv_in(unet: UNet, in_channels: int) -> UNet:
    """A copy of ``unet`` whose conv_in takes ``in_channels`` input channels,
    the new ones zero (axis 1 of the OIHW weight): the ip2p initialisation,
    so that step 0 computes the text-to-image model's eps. Same dtype and
    device as ``unet``."""
    w = unet.conv_in.weight
    if in_channels < w.shape[1]:
        raise ValueError(f"conv_in has {w.shape[1]} input channels, more than {in_channels}")
    sd = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    if in_channels > w.shape[1]:
        pad = torch.zeros((w.shape[0], in_channels - w.shape[1]) + w.shape[2:], dtype=w.dtype,
                          device=w.device)
        sd["conv_in.weight"] = torch.cat([sd["conv_in.weight"], pad], dim=1)
    with torch.device("meta"):
        out = UNet(dataclasses.replace(unet.config, in_channels=in_channels))
    out.load_state_dict(sd, strict=True, assign=True)
    return out.requires_grad_(False)


def cond_dropout_masks(r: torch.Tensor, uncond_prob: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(drop_prompt, keep_image) from per-item uniforms r: the exact
    ddpm_edit.py rule (r < 2u drops the prompt, u <= r < 3u the image)."""
    u = uncond_prob
    drop_prompt = r < 2 * u
    keep_image = ~((r >= u) & (r < 3 * u))
    return drop_prompt, keep_image


# the JAX layout's axis of each torch axis of a weight: a Linear's (out, in)
# is JAX's (in, out) transposed, a Conv2d's OIHW is JAX's HWIO
_JAX_AXES = {2: (1, 0), 4: (3, 2, 0, 1)}


def zero_partition(shape: Sequence[int], world: int) -> Optional[int]:
    """The axis along which ZeRO splits a tensor of this (port-layout) shape
    into ``world`` blocks, one a rank: the largest axis ``world`` divides,
    ties going to the axis that comes first in the JAX layout, so that it is
    the axis the JAX ``zero_shardings`` picks for the same leaf; None (the
    whole tensor on every rank) when no axis qualifies or ``world`` is 1."""
    if world <= 1:
        return None
    jax_axes = _JAX_AXES.get(len(shape), tuple(range(len(shape))))
    axes = [a for a in range(len(shape)) if shape[a] % world == 0 and shape[a] >= world]
    return min(axes, key=lambda a: (-shape[a], jax_axes[a])) if axes else None


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of optimizer step ``step``'s draws, seeded from (seed,
    step): the JAX runner's ``fold_in(root, step)``. A resumed run draws what
    an uninterrupted one draws."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def adamw_update_(params: List[torch.Tensor], grads: List[torch.Tensor],
                  mu: List[torch.Tensor], nu: List[torch.Tensor], count: int, lr: float,
                  cfg: TrainConfig, grad_norm: torch.Tensor) -> None:
    """One step of optax's ``chain(clip_by_global_norm(clip_grad), adamw(lr,
    b1, b2, eps, weight_decay))`` in place, in optax's order of operations:
    the clip ``where(norm < max, g, g / norm * max)`` (only when clip_grad >
    0); the moments ``(1-b) g^k + b m``; the bias corrections with the
    incremented ``count``; ``mu_hat / (sqrt(nu_hat) + eps)``; plus
    ``wd * p`` on every tensor (optax's adamw has no mask); times ``-lr``
    (the schedule at ``count``); added to the parameters. ``grads`` are
    overwritten."""
    b1, b2 = cfg.betas
    if cfg.clip_grad > 0 and not bool(grad_norm < cfg.clip_grad):
        torch._foreach_div_(grads, grad_norm)
        torch._foreach_mul_(grads, cfg.clip_grad)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
    n = F32(count + 1)
    bc1, bc2 = (float(F32(1.0) - F32(b) ** n) for b in (b1, b2))
    torch._foreach_copy_(grads, mu)  # the update goes into grads' storage
    torch._foreach_div_(grads, bc1)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    torch._foreach_div_(grads, denom)
    del denom
    torch._foreach_add_(grads, params, alpha=cfg.weight_decay)
    torch._foreach_mul_(grads, -lr)
    torch._foreach_add_(params, grads)


def _f32_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A deep copy of ``module`` with f32 parameters and buffers (memory
    format kept), built on the meta device so the source is read once."""
    sd = {k: v.detach().to(torch.float32, copy=True) for k, v in module.state_dict().items()}
    with torch.device("meta"):
        out = type(module)(module.config)
    out.load_state_dict(sd, strict=True, assign=True)
    return out


class EditTrainer:
    """The train and validation steps and the training state, on one device
    or data parallel over ``group`` (one device a rank).

    State: ``unet`` (the f32 masters, an ``in_channels``-channel UNet that
    requires grad), ``ema`` (an f32 UNet), the Adam moments ``mu``/``nu``
    (f32, by parameter name; with ZeRO, each rank's block of each tensor),
    ``count`` (Adam's and the schedule's) and ``step``. ``frozen``: {"vae":
    VAE, "text": CLIPTextModel}, used as they are (a bf16 pipeline's modules
    compute in bf16 on bf16 inputs). ``batch_per_step`` is the global batch
    of a microbatch, of which each dp rank takes ``batch_per_step / W`` rows
    (W the dp group's size). With ``tp_group`` the UNet and the state are
    split by output columns over it (the module docstring)."""

    def __init__(self, model_config: StableDiffusionConfig, frozen: Dict[str, torch.nn.Module],
                 unet: UNet, cfg: TrainConfig, batch_per_step: int, null_ids, group=None,
                 tp_group=None):
        self.config = model_config
        self.cfg = cfg
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.tp_group = tp_group
        self.tp = dist.get_world_size(tp_group) if tp_group is not None else 1
        self.tp_rank = dist.get_rank(tp_group) if tp_group is not None else 0
        if batch_per_step % self.world:
            raise ValueError(f"batch_per_step {batch_per_step} is not a multiple of the "
                             f"{self.world} ranks")
        if is_quantized(unet):
            raise ValueError("the trainer trains a float UNet: w8 (ops/quant.py) is for "
                             "inference")
        self.vae: VAE = frozen["vae"]
        self.text: CLIPTextModel = frozen["text"]
        self._lr = lambda_linear_lr(cfg, self.world, batch_per_step)
        self.unet = _f32_copy(unet).requires_grad_(True)
        self.ema = _f32_copy(unet).requires_grad_(False)
        if tp_group is not None:
            shard_columns_(self.unet, tp_group)
            shard_columns_(self.ema, tp_group)
        self.device = self.unet.conv_in.weight.device
        self.names = [n for n, _ in self.unet.named_parameters()]
        axes = tp_axes(self.unet)
        self.tp_axes = [axes[n] for n in self.names]
        self.params = [p for _, p in self.unet.named_parameters()]
        ema = dict(self.ema.named_parameters())
        self.ema_params = [ema[n] for n in self.names]
        self.parts = [zero_partition(p.shape, self.world) if cfg.zero else None
                      for p in self.params]
        self.mu = [torch.zeros(self._own(p, a).shape, dtype=torch.float32, device=self.device)
                   for p, a in zip(self.params, self.parts)]
        self.nu = [torch.zeros_like(m) for m in self.mu]
        self.count = 0
        self.step = 0
        self.null_ids = torch.as_tensor(null_ids).to(device=self.device, dtype=torch.int64)
        self.acp = torch.as_tensor(make_ddim_schedule().alphas_cumprod, device=self.device)
        self.latent_factor = 2 ** (len(model_config.vae.block_out_channels) - 1)

    def _own(self, t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        return multihost.block(t, axis, self.rank, self.world)

    # ------------------------------------------------------------------ loss
    def draw(self, batch: int, image_hw: int, generator: Optional[torch.Generator]) -> Draws:
        """One microbatch's draws, in the JAX trainer's order of keys: the
        posterior noise z, the timesteps t, the q_sample noise and the
        dropout uniforms r."""
        h = image_hw // self.latent_factor
        shape = (batch, h, h, self.config.vae.latent_channels)
        kw = dict(generator=generator, device=self.device)
        return {"z": torch.randn(shape, **kw),
                "t": torch.randint(0, self.acp.shape[0], (batch,), **kw),
                "noise": torch.randn(shape, **kw),
                "r": torch.rand((batch,), **kw)}

    def microbatch_loss(self, unet: UNet, edited: torch.Tensor, cond_image: torch.Tensor,
                        ids: torch.Tensor, draws: Draws) -> torch.Tensor:
        """The f32 loss of one microbatch: edited/cond_image (B, H, W, 3) f32
        in [-1, 1], ids (B, 77), ``draws`` as ``draw`` gives them."""
        dt = self.cfg.dtype
        b = edited.shape[0]
        with torch.no_grad():
            z = self.vae.encode(edited.to(dt), noise=draws["z"].to(dt))
            img_cond = self.vae.encode(cond_image.to(dt), scale=False)
            ids2 = torch.cat([ids, self.null_ids.expand(b, -1)])
            ctx2 = self.text(ids2, dtype=dt)
            drop_prompt, keep_image = cond_dropout_masks(draws["r"], self.cfg.uncond_prob)
            ctx = torch.where(drop_prompt[:, None, None], ctx2[b:], ctx2[:b])
            img_cond = img_cond * keep_image[:, None, None, None].to(dt)
            t = draws["t"]
            a = self.acp[t][:, None, None, None]
            noise = draws["noise"].to(dt)
            x_noisy = (torch.sqrt(a) * z.float()
                       + torch.sqrt(1.0 - a) * noise.float()).to(dt)
            x_in = torch.cat([x_noisy, img_cond], dim=-1)

        def unet_fwd(x, tt, cc):
            return unet(x, tt, cc)[0]

        if self.cfg.remat and torch.is_grad_enabled():
            eps = torch.utils.checkpoint.checkpoint(unet_fwd, x_in, t, ctx, use_reentrant=False)
        else:
            eps = unet_fwd(x_in, t, ctx)
        err = (eps.float() - noise.float()) ** 2
        return torch.mean(torch.mean(err, dim=(1, 2, 3)))

    def _microbatches(self, batch: Dict[str, Any], generator, draws):
        edited, cond_image, ids = (torch.as_tensor(batch[k], device=self.device)
                                   for k in ("edited", "cond_image", "ids"))
        b = edited.shape[1]
        for i in range(edited.shape[0]):
            d = (draws[i] if draws is not None
                 else self.draw(b * self.world, edited.shape[2], generator))
            if d["t"].shape[0] != b * self.world:
                raise ValueError(f"the draws hold {d['t'].shape[0]} rows, want the global "
                                 f"batch's {b * self.world}")
            if self.world > 1:  # this rank's rows of the global batch's draws
                d = {k: v[self.rank * b: (self.rank + 1) * b] for k, v in d.items()}
            yield edited[i].float(), cond_image[i].float(), ids[i].long(), d

    # ------------------------------------------------------------------ step
    def train_step(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[Draws]] = None) -> Dict[str, torch.Tensor]:
        """batch: this rank's rows, edited/cond_image (A, B/W, H, W, 3) f32,
        ids (A, B/W, 77); A microbatches, each drawing the global batch's
        draws from ``generator`` (or taking ``draws[i]``, the global batch's)
        and keeping this rank's rows. Returns {"loss", "grad_norm"} (f32
        scalars, over the global batch)."""
        for p in self.params:
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        n = 0
        for edited, cond_image, ids, d in self._microbatches(batch, generator, draws):
            mb = self.microbatch_loss(self.unet, edited, cond_image, ids, d)
            mb.backward()
            loss = loss + mb.detach()
            n += 1
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        for p in self.params:
            p.grad = None
        with torch.no_grad():
            if self.group is not None:  # the sums over every rank's rows, then the mean
                multihost.all_reduce_(grads + [loss], self.group)
            torch._foreach_div_(grads, n * self.world)
            loss = loss / (n * self.world)
            gnorm = self._grad_norm(grads)
            adamw_update_([self._own(p, a) for p, a in zip(self.params, self.parts)],
                          [self._own(g, a) for g, a in zip(grads, self.parts)],
                          self.mu, self.nu, self.count, self._lr(self.count), self.cfg, gnorm)
            del grads
            self._assemble_params()
            self.count += 1
            self.step += 1
            # LitEMA's warm-up on the incremented step, in f32
            d = min(F32(self.cfg.ema_decay), (F32(1.0) + F32(self.step))
                    / (F32(10.0) + F32(self.step)))
            torch._foreach_mul_(self.ema_params, float(d))
            torch._foreach_add_(self.ema_params, self.params, alpha=float(F32(1.0) - d))
        return {"loss": loss, "grad_norm": gnorm}

    def _grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradients: the split tensors' blocks'
        squares summed over the tp group."""
        if self.tp_group is None:
            return global_norm(grads)
        split = [g for g, a in zip(grads, self.tp_axes) if a is not None]
        whole = [g for g, a in zip(grads, self.tp_axes) if a is None]
        sq = global_norm(split).square()
        multihost.all_reduce_([sq], self.tp_group)
        return torch.sqrt(sq + global_norm(whole).square())

    def _assemble_params(self) -> None:
        """Every rank's updated blocks into every rank's parameters
        (``multihost.all_gather_blocks_``)."""
        split = [(p, a) for p, a in zip(self.params, self.parts) if a is not None]
        if split:
            multihost.all_gather_blocks_([p for p, _ in split], [a for _, a in split],
                                         self.group)

    @torch.no_grad()
    def val_step(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 draws: Optional[Sequence[Draws]] = None) -> torch.Tensor:
        """The loss under the EMA weights (the reference copies the EMA into
        the model for its validation pass), over the global batch."""
        losses = [self.microbatch_loss(self.ema, e, c, i, d)
                  for e, c, i, d in self._microbatches(batch, generator, draws)]
        loss = torch.stack(losses).sum()
        if self.group is not None:
            multihost.all_reduce_([loss], self.group)
        return loss / (len(losses) * self.world)

    def learning_rate(self, step: Optional[int] = None) -> float:
        return self._lr(self.step if step is None else step)

    # ---------------------------------------------------------------- state
    def _whole(self, tensors: Sequence[torch.Tensor], dp_axes: Sequence[Optional[int]],
               keep: bool = True) -> Dict[str, Optional[torch.Tensor]]:
        """This rank's tensors (one per parameter, each its ZeRO block along
        ``dp_axes`` of its tp block along ``tp_axes``) whole, by name: as
        they are where both are whole, else every rank's blocks gathered
        over dp, then over tp, bucket by bucket (collectives) and kept on
        the host (not kept without ``keep``: a rank that only takes part in
        the gathers)."""
        out = dict(zip(self.names, tensors))
        todo = [i for i, (a, b) in enumerate(zip(dp_axes, self.tp_axes))
                if a is not None or b is not None]
        while todo:  # one bucket of whole tensors at a time on the card
            bucket, size = [], 0
            while todo and (not bucket or size + self.params[todo[0]].numel() * self.tp * 4
                            <= multihost.BUCKET_BYTES):
                bucket.append(todo.pop(0))
                size += self.params[bucket[-1]].numel() * self.tp * 4
            cur = [tensors[i] for i in bucket]
            for axes, world, rank, group in ((dp_axes, self.world, self.rank, self.group),
                                             (self.tp_axes, self.tp, self.tp_rank,
                                              self.tp_group)):
                sel = [k for k, i in enumerate(bucket) if axes[i] is not None]
                for k in sel:
                    shape = list(cur[k].shape)
                    shape[axes[bucket[k]]] *= world
                    w = torch.empty(shape, dtype=cur[k].dtype, device=cur[k].device)
                    multihost.block(w, axes[bucket[k]], rank, world).copy_(cur[k])
                    cur[k] = w
                if sel:
                    multihost.all_gather_blocks_([cur[k] for k in sel],
                                                 [axes[bucket[k]] for k in sel], group)
            for i, t in zip(bucket, cur):
                out[self.names[i]] = t.cpu() if keep else None
        return out

    def state_dict(self, keep: bool = True) -> Dict[str, Any]:
        """The whole training state, by parameter name (a collective when
        the moments or the layers are split: every rank calls it; ``keep``
        False where a rank only takes part)."""
        whole = [None] * len(self.names)
        return {"params": self._whole([p.detach() for p in self.params], whole, keep),
                "ema": self._whole([p.detach() for p in self.ema_params], whole, keep),
                "mu": self._whole(self.mu, self.parts, keep),
                "nu": self._whole(self.nu, self.parts, keep),
                "count": self.count, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copies a whole state (``state_dict``'s layout, from any number of
        ranks; tensors or numpy arrays, e.g. ``convert.train_state_from_jax``'s)
        into this trainer: the blocks this rank owns (its tp column blocks,
        and of the moments its ZeRO blocks of those)."""
        for key, dst, parts in (("params", self.params, None), ("ema", self.ema_params, None),
                                ("mu", self.mu, self.parts), ("nu", self.nu, self.parts)):
            src = state[key]
            if set(src) != set(self.names):
                raise KeyError(f"{key}: the state's names differ from the UNet's: "
                               f"{sorted(set(src) ^ set(self.names))[:5]}")
            for i, (name, t) in enumerate(zip(self.names, dst)):
                v = src[name]
                v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                    np.array(v, dtype=np.float32))
                v = multihost.block(v, self.tp_axes[i], self.tp_rank, self.tp)
                t.copy_(self._own(v, parts[i]) if parts is not None else v)
        self.count, self.step = int(state["count"]), int(state["step"])

    def save(self, directory: str) -> str:
        """Writes the whole state to ``<directory>/step_<n:08d>.pt`` (rank 0
        of both groups writes; a collective: every rank calls it, and it
        returns when the file is complete); returns its path."""
        path = os.path.join(os.path.abspath(directory), f"step_{self.step:08d}.pt")
        writer = self.rank == 0 and self.tp_rank == 0
        state = self.state_dict(keep=writer)  # every rank takes part in the gathers
        if writer:
            os.makedirs(directory, exist_ok=True)
            torch.save(state, path + ".tmp")
            os.replace(path + ".tmp", path)
        del state
        for group in (self.tp_group, self.group):
            if group is not None:
                dist.barrier(group)
        return path

    def restore(self, path: Optional[str] = None, directory: Optional[str] = None) -> bool:
        """Loads ``path``, or the latest ``step_*.pt`` in ``directory``, saved
        at any number of ranks; returns False (a fresh run) when there is
        none. The file is mapped, not read whole: a rank reads what it keeps."""
        if path is None:
            if directory is None:
                raise ValueError("restore: give a checkpoint path or a directory")
            steps = sorted(f for f in (os.listdir(directory) if os.path.isdir(directory) else [])
                           if f.startswith("step_") and f.endswith(".pt"))
            if not steps:
                return False
            path = os.path.join(directory, steps[-1])
        self.load_state_dict(torch.load(path, map_location="cpu", weights_only=True, mmap=True))
        return True
