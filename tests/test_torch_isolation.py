"""The PyTorch port imports neither JAX nor anything of the JAX package:
every module of ``pnpinversion_tpu_torch`` (and ``chip_smoke.py``) imports
in a fresh interpreter where both are blocked."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "pnpinversion_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import pnpinversion_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pnpinversion_tpu_torch.__path__,
                                               "pnpinversion_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m, v in sys.modules.items()
                if v is not None and (m.split(".")[0] in ("jax", "jaxlib")
                                      or m == "pnpinversion_tpu"
                                      or m.startswith("pnpinversion_tpu.")))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20  # every module was reached
