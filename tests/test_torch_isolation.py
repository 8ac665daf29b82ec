"""The PyTorch port imports neither JAX nor anything of the JAX package, nor
the weight-file packages the GPU host lacks (``safetensors``,
``transformers``, ``diffusers``, ``orbax``): every module of
``pnpinversion_tpu_torch`` (and ``chip_smoke.py``, ``scripts/rehearse_torch.py``
and ``scripts/mfu_torch.py``) imports in a fresh interpreter where all of
them are blocked."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "pnpinversion_tpu", "safetensors", "transformers", "diffusers",
           "orbax")
for name in BLOCKED:
    sys.modules[name] = None  # any import of them now raises ImportError
import pnpinversion_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pnpinversion_tpu_torch.__path__,
                                               "pnpinversion_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for script in ("rehearse_torch", "mfu_torch"):
    spec = importlib.util.spec_from_file_location(script, f"scripts/{script}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 95  # every module was reached, the entry points' among them
    assert {"pnpinversion_tpu_torch.parallel.sweep", "pnpinversion_tpu_torch.editors.p2p_editor",
            "pnpinversion_tpu_torch.inversion.ddim_inversion",
            "pnpinversion_tpu_torch.sampling.p2p_forward",
            "pnpinversion_tpu_torch.control.masactrl", "pnpinversion_tpu_torch.control.pnp",
            "pnpinversion_tpu_torch.editors.masactrl_editor",
            "pnpinversion_tpu_torch.editors.pnp_editor",
            "pnpinversion_tpu_torch.editors.ef_editor",
            "pnpinversion_tpu_torch.inversion.ef_ddpm",
            "pnpinversion_tpu_torch.schedulers.edict", "pnpinversion_tpu_torch.schedulers.edict_df",
            "pnpinversion_tpu_torch.control.edict_p2p",
            "pnpinversion_tpu_torch.editors.edict_editor",
            "pnpinversion_tpu_torch.sampling.kdiffusion",
            "pnpinversion_tpu_torch.editors.instruct_editor",
            "pnpinversion_tpu_torch.editors.bld_editor",
            "pnpinversion_tpu_torch.editors.pix2pix_zero_editor",
            "pnpinversion_tpu_torch.editors.stylediffusion_editor",
            "pnpinversion_tpu_torch.control.attn_store",
            "pnpinversion_tpu_torch.control.stylediffusion",
            "pnpinversion_tpu_torch.inversion.pix2pix_zero",
            "pnpinversion_tpu_torch.inversion.stylediffusion",
            "pnpinversion_tpu_torch.models.blip",
            "pnpinversion_tpu_torch.models.stylediffusion",
            "pnpinversion_tpu_torch.utils.observability",
            "pnpinversion_tpu_torch.training.data", "pnpinversion_tpu_torch.training.multitask",
            "pnpinversion_tpu_torch.training.prompt_dataset",
            "pnpinversion_tpu_torch.training.trainer",
            "pnpinversion_tpu_torch.training.dataset_creation",
            "pnpinversion_tpu_torch.runners.run_prompt_dataset",
            "pnpinversion_tpu_torch.runners.run_dataset_creation",
            "pnpinversion_tpu_torch.runners.run_training_instructpix2pix",
            "pnpinversion_tpu_torch.convert.checkpoint", "pnpinversion_tpu_torch.cli",
            "pnpinversion_tpu_torch.runners.run_editing_p2p",
            "pnpinversion_tpu_torch.runners.run_sweep",
            "pnpinversion_tpu_torch.parallel.multihost",
            "pnpinversion_tpu_torch.runners.run_sweep_sharded",
            "pnpinversion_tpu_torch.evaluation.sharded", "pnpinversion_tpu_torch.ops.quant",
            "pnpinversion_tpu_torch.parallel.tensor_parallel",
            "pnpinversion_tpu_torch.parallel.agreement",
            "pnpinversion_tpu_torch.data.seeded", "pnpinversion_tpu_torch.utils.flops",
            "pnpinversion_tpu_torch.utils.mfu",
            "pnpinversion_tpu_torch.data._native"} <= names
