"""repro_torch stands alone: it imports neither jax nor the reference
package `repro`, so it runs where jax is absent. A subprocess with both
blocked in `sys.modules` imports every module of the port and runs a
1-round CPU simulation, then slice 4's codec and async runs, secure
aggregation and the dequantize-aggregate path, then one reduced zoo
train step (slice 12) and one count-only dry-run of it on a 4x2 mesh
(slice 14); a source scan covers chip_smoke.py too."""
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
import os, sys
xla_flags = os.environ.get("XLA_FLAGS")
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
# slice 4: a codec on the wire, the async runtime, secure aggregation and
# the fused dequantize-aggregate kernel's plain path
for kw in (dict(strategy="afl", codec="qsgd"),
           dict(strategy="async", codec="topk", speed_model="uniform",
                updates_per_client=1, tick=1.0)):
    r = FederatedSimulation(FLConfig(**dict(fl.__dict__, **kw)), ds,
                            device="cpu").run()
    assert r.extra["communication"]["compression_ratio"] > 1.0
from repro_torch.core import secure_agg
from repro_torch.kernels import ops
p = {"w": torch.ones(3)}
assert torch.allclose(secure_agg.secure_fedavg([p, p])["w"], p["w"],
                      atol=1e-4)
assert ops.dequant_aggregate(torch.ones((2, 3), dtype=torch.int8),
                             torch.ones(2), torch.full((2,), 0.5)).sum() == 3
# slice 12: one reduced train step of the zoo, on MarkovLM tokens
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import MarkovLM
from repro_torch.device import generator
from repro_torch.launch.train import device_batch, make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim import optimizers
cfg = get_config("phi3-mini-3.8b").reduced(num_layers=1)
model = build_model(cfg)
params = model.init(generator(0), "cpu")
opt = optimizers.adamw(1e-3, weight_decay=0.01)
batch = next(MarkovLM(cfg.vocab_size).batches(2, 16, 1))
params, _, m = make_train_step(model, opt)(params, opt.init(params),
                                           device_batch(batch, "cpu"))
assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
# slice 14: one count-only dry-run of a reduced config on a 4x2 mesh
from repro_torch.launch import dryrun
from repro_torch.sharding.specs import MeshShape
d = dryrun.run_step(cfg, "train", 8, 16, MeshShape((4, 2), ("data", "model")))
assert d["flops"] > 0 and d["counts"]["kinds"]["all-gather"] > 0
assert os.environ.get("XLA_FLAGS") == xla_flags
assert "repro_torch.api" in sys.modules and "repro_torch.core.trainer" in names
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
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
