"""repro_torch stands alone: it imports neither jax nor the reference
package `repro`, so it runs where jax is absent. A subprocess with both
blocked in `sys.modules` imports every module of the port and runs a
1-round CPU simulation; a source scan covers chip_smoke.py too."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import importlib, pkgutil
import torch
torch.set_num_threads(1)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None), \
    sorted(k for k in sys.modules if k.startswith(("jax", "repro.")))
from repro_torch.core.fl_types import FLConfig
from repro_torch.core.simulation import FederatedSimulation
from repro_torch.data.synthetic import mnist_like
ds = mnist_like(seed=0, n_train=128, n_test=32)
fl = FLConfig(strategy="hfl", engine="vectorized", num_clients=4,
              num_groups=2, rounds=1, local_batch_size=16)
r = FederatedSimulation(fl, ds, device="cpu").run()
assert 0.0 <= r.test_accuracy <= 1.0
print("ok", len(names))
"""


def test_port_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.startswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro\b(?!_torch))", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_sources_import_no_jax_or_repro(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(text), _FORBIDDEN.findall(text)
