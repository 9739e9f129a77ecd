"""The port's dry-run (`repro_torch.launch.dryrun`) and the roofline's
collective terms (`launch.roofline.collective_bytes`, `analyze`) on the
CPU, on the meta device.

* The reference test's four (arch, profile) pairs
  (tests/test_sharding_and_dryrun.py:110-128), reduced with vocab 512, run
  rank 0's sharded train step on a 4x2 mesh (B = 8, S = 64) under the
  count-only collectives: FLOPs > 0, and collectives under tp and fsdp.
* `collective_bytes` weighs the counted kinds as the reference's
  `parse_collective_bytes` weighs the ops of `test_collective_parser`.
* `lower_and_compile` and `lower_fl` return the reference's JSON keys;
  the CLI writes one file a job and skips it when cached.
* A dry-run in a process with jax and `repro` blocked sets no
  `XLA_FLAGS` and imports neither.

Full-size configurations are left to the card's host (PERF.md); here
`get_config` is patched to the reduced configs."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.sharding.specs import MeshShape  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch,profile", [
    ("phi3-mini-3.8b", "tp"),
    ("qwen3-moe-30b-a3b", "tp"),
    ("zamba2-1.2b", "fsdp"),
    ("xlstm-125m", "dp"),
])
def test_small_mesh_dry_run(arch, profile):
    cfg = registry.get_config(arch).reduced().with_updates(
        sharding_profile=profile, vocab_size=512)
    m = dryrun.run_step(cfg, "train", 8, 64,
                        MeshShape((4, 2), ("data", "model")))
    assert m["flops"] > 0 and m["bytes"] > 0 and m["temp_bytes"] > 0
    coll = rl.collective_bytes(m["counts"])
    if profile in ("tp", "fsdp"):
        assert coll["count"] > 0 and coll["total"] > 0, m["counts"]
        assert m["counts"]["kinds"]["all-gather"] > 0
    # the count-only mode issued nothing: no process group exists here
    assert not torch.distributed.is_initialized()


def test_collective_bytes_weighs_as_the_reference_parser():
    """The op list of the reference's test_collective_parser, as the
    counts of core/collectives.py record it."""
    counts = {"kinds": {"all-reduce": 1, "all-gather": 1,
                        "collective-permute": 1, "all-to-all": 1},
              "kind_bytes": {"all-reduce": 128 * 256 * 4,
                             "all-gather": 64 * 2,
                             "collective-permute": 8 * 8 * 4,
                             "all-to-all": 16 * 16 * 4 + 4 * 4}}
    got = rl.collective_bytes(counts)
    assert got["count"] == 4
    assert got["all-reduce"] == 2 * 128 * 256 * 4
    assert got["all-gather"] == 64 * 2
    assert got["collective-permute"] == 8 * 8 * 4
    assert got["all-to-all"] == 16 * 16 * 4 + 4 * 4
    assert got["reduce-scatter"] == 0
    assert got["total"] == sum(got[k] for k in rl._WEIGHT)
    roof = rl.analyze(1e12, 2e9, counts, 8, 3e9)
    assert roof.collective_bytes_per_device == got["total"]
    assert roof.collective_count == 4
    assert roof.collective_s == got["total"] / rl.LINK_BW


STD_KEYS = {"arch", "shape", "mesh", "chips", "opts", "kind", "params",
            "active_params", "model_flops_total", "model_flops_per_device",
            "scan_cost_corrected", "lower_s", "compile_s", "memory",
            "roofline", "useful_flops_ratio", "ok"}
FL_KEYS = {"arch", "fl_strategy", "mesh", "chips", "clients", "seq_len",
           "per_client_batch", "lower_s", "compile_s", "memory", "roofline",
           "ok"}
ROOF_KEYS = {"flops_per_device", "bytes_per_device",
             "collective_bytes_per_device", "collective_count", "chips",
             "peak_memory_per_device", "compute_s", "memory_s",
             "collective_s", "dominant"}


@pytest.fixture
def reduced(monkeypatch):
    orig = registry.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: orig(a).reduced())


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_result_has_the_reference_keys(reduced, shape):
    r = dryrun.lower_and_compile("yi-9b", shape, multi_pod=True,
                                 verbose=False)
    assert set(r) == STD_KEYS
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "peak_bytes"}
    assert set(r["roofline"]) == ROOF_KEYS
    assert r["ok"] and r["chips"] == 512 and r["mesh"] == "2x16x16"
    assert r["scan_cost_corrected"] is False
    assert r["roofline"]["flops_per_device"] > 0
    assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("strategy,mode", [
    ("hfl", "fedavg"), ("afl", "fedavg"), ("afl", "gossip"),
    ("cfl", "fedavg")])
def test_fl_result_has_the_reference_keys(reduced, strategy, mode):
    r = dryrun.lower_fl("phi3-mini-3.8b", strategy, afl_mode=mode,
                        verbose=False)
    assert set(r) == FL_KEYS and set(r["roofline"]) == ROOF_KEYS
    assert r["clients"] == 16 and r["ok"]
    assert r["roofline"]["collective_count"] > 0
    assert r["fl_strategy"] == (strategy if mode == "fedavg"
                                else f"{strategy}-{mode}")


def test_cli_writes_one_file_a_job(reduced, tmp_path, capsys):
    out = tmp_path / "dry"
    assert dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    assert [p.name for p in out.iterdir()] == ["yi-9b_decode_32k_16x16.json"]
    assert dryrun.main(["--fl", "hfl", "--arch", "phi3-mini-3.8b",
                        "--mesh", "both", "--out", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "fl_hfl_phi3-mini-3.8b_16x16.json",
        "fl_hfl_phi3-mini-3.8b_2x16x16.json",
        "yi-9b_decode_32k_16x16.json"]
    capsys.readouterr()
    dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k", "--out",
                 str(out)])
    assert "skip (cached)" in capsys.readouterr().out


_CHILD = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.configs import registry
from repro_torch.launch import dryrun
orig = registry.get_config
dryrun.get_config = lambda a: orig(a).reduced()
r = dryrun.lower_and_compile("zamba2-1.2b", "train_4k", verbose=False)
assert r["ok"] and "XLA_FLAGS" not in os.environ
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_dry_run_sets_no_xla_flags_and_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"
