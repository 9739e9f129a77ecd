"""The port's twins of the reference's example scripts
(`repro_torch.examples`), on the CPU.

* Flags: each twin's option strings, choices, defaults, types and
  actions equal the reference script's, read from the parsers both
  scripts build (each package's four scripts in one subprocess, their
  `parse_args` replaced by a dump); `--device` (default "cuda") is the
  one flag a twin adds, and only the twins that touch a device add it:
  the multipod demo's dry-run runs on the meta device.
* Runs: each twin with `tests/test_examples.py`'s arguments (and
  `--device cpu`) prints the lines the reference script prints, in its
  order. The FL twin's metrics equal a direct
  `repro_torch.api.FederatedSimulation(...).run()` of the same config;
  `--scenario NAME` prints `run_scenario`'s document (values of
  `timing` and `telemetry` aside); `--curves` writes under
  `experiments/curves/` of the working directory, not at its root; the
  serve twin's tokens equal `greedy_generate`'s; the quickstart restores
  its checkpoint bit for bit. Everything written lands in `tmp_path`.
"""
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import federated_image_classification as fl_twin  # noqa: E402,E501
from repro_torch.examples import multipod_dryrun_demo as dry_twin  # noqa: E402
from repro_torch.examples import quickstart as qs_twin  # noqa: E402
from repro_torch.examples import serve_decode as serve_twin  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCRIPTS = ("quickstart", "federated_image_classification", "serve_decode",
           "multipod_dryrun_demo")
FL_ARGS = ["--strategy", "afl", "--dataset", "mnist", "--rounds", "2",
           "--clients", "4", "--n-train", "400"]

# each script's parser, dumped instead of parsed: the reference scripts
# run as files, the twins as modules
_DUMP = r"""
import argparse, json, runpy, sys
out = {}
def dump(self, args=None, namespace=None):
    out[NAME] = sorted(
        [a.option_strings, sorted(map(str, a.choices)) if a.choices else None,
         a.default, getattr(a.type, "__name__", None), type(a).__name__]
        for a in self._actions if a.option_strings != ["-h", "--help"])
    raise SystemExit(0)
argparse.ArgumentParser.parse_args = dump
for NAME, target in json.loads(sys.argv[1]).items():
    sys.argv = [target]
    try:
        if target.endswith(".py"):
            runpy.run_path(target, run_name="__main__")
        else:
            runpy.run_module(target, run_name="__main__")
    except SystemExit:
        pass
print("PARSERS " + json.dumps(out))
"""


def _parsers(targets):
    # one temp dir for both packages: the quickstart's --ckpt-dir default
    # lies under it
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               TMPDIR="/tmp")
    return subprocess.Popen(
        [sys.executable, "-c", _DUMP, json.dumps(targets)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _read(proc):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-2000:]
    line = next(x for x in out.splitlines() if x.startswith("PARSERS "))
    return json.loads(line[len("PARSERS "):])


def test_twins_take_the_reference_flags_plus_device():
    ref = _parsers({n: os.path.join(ROOT, "examples", n + ".py")
                    for n in SCRIPTS})
    port = _parsers({n: "repro_torch.examples." + n for n in SCRIPTS})
    ref, port = _read(ref), _read(port)
    assert sorted(ref) == sorted(port) == sorted(SCRIPTS)
    device = [["--device"], None, "cuda", None, "_StoreAction"]
    for name in SCRIPTS:
        want = ref[name]
        if name != "multipod_dryrun_demo":
            want = sorted(want + [device])
        assert port[name] == want, name
    assert len(ref["federated_image_classification"]) == 38   # all dumped


def _lines(text):
    return [x for x in text.splitlines() if x.strip()]


def _assert_lines(text, patterns):
    """Every pattern matches a line, in this order."""
    lines, i = _lines(text), 0
    for pat in patterns:
        while i < len(lines) and not re.match(pat, lines[i]):
            i += 1
        assert i < len(lines), (pat, text[-3000:])
        i += 1


def test_quickstart_twin(tmp_path, capsys):
    out = qs_twin.main(["--arch", "xlstm-125m", "--steps", "8", "--batch",
                        "2", "--seq-len", "64", "--ckpt-dir", str(tmp_path),
                        "--device", "cpu"])
    text = capsys.readouterr().out
    # the reference's lines (examples/quickstart.py, launch/train.py)
    _assert_lines(text, [r"arch=xlstm-125m \(ssm\), reduced: 2L d=256 "
                         r"vocab=512$",
                         r"step +0 +loss ", r"step +7 +loss ",
                         r"loss: \d+\.\d{3} -> \d+\.\d{3}$",
                         r"checkpointed -> ", r"greedy continuation: \["])
    hist = out["history"]
    assert hist[-1][1] < hist[0][1]
    assert out["path"].startswith(str(tmp_path)) and os.path.exists(
        out["path"])
    for a, b in zip(tree_leaves(out["params"]), tree_leaves(out["restored"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert out["generated"].shape == (1, 16)
    assert out["generated"][0, :4].tolist() == [1, 2, 3, 4]


def _fl_metric_lines(r, strategy="afl", iid=True):
    lines = [f"=== {strategy.upper()} on mnist-like "
             f"({'IID' if iid else 'non-IID'}) ===",
             f"training acc:       {r.train_accuracy:.3f}",
             f"testing acc:        {r.test_accuracy:.3f}",
             f"precision/recall:   {r.precision:.3f} / {r.recall:.3f}",
             f"F1 / balanced acc:  {r.f1:.3f} / {r.balanced_accuracy:.3f}",
             "confusion matrix:"]
    lines += ["   " + " ".join(f"{v:4d}" for v in row) for row in r.confusion]
    return lines


def test_federated_twin_prints_a_direct_runs_metrics(tmp_path, capsys,
                                                     monkeypatch):
    from repro_torch import api
    from repro_torch.data.synthetic import DATASETS

    monkeypatch.chdir(tmp_path)
    r = fl_twin.main(FL_ARGS + ["--curves", "--device", "cpu"])
    text = capsys.readouterr().out
    _assert_lines(text, [r"=== AFL on mnist-like \(IID\) ===$",
                         r"training acc: ", r"testing acc: ",
                         r"precision/recall: ", r"F1 / balanced acc: ",
                         r"build time: +\d+\.\d\ds \(\+ \d+\.\d\ds warmup\)$",
                         r"classification: +\d+\.\d{4}s$",
                         r"phase breakdown \(host dispatch\):$",
                         r"confusion matrix:$",
                         r"curves -> experiments/curves/curves_afl_mnist"
                         r"\.csv$"])
    # the curves land under the output-dir convention, not at the root
    assert (tmp_path / "experiments" / "curves"
            / "curves_afl_mnist.csv").exists()
    assert not (tmp_path / "curves_afl_mnist.csv").exists()
    rows = (tmp_path / "experiments" / "curves"
            / "curves_afl_mnist.csv").read_text().splitlines()
    assert rows[0] == "round,train_acc,train_loss,test_acc" and len(rows) == 3

    ds = DATASETS["mnist"](n_train=400, n_test=500)
    # the config the twin builds from these flags and its defaults
    fl = api.FLConfig(strategy="afl", num_clients=4, num_groups=2, rounds=2,
                      local_epochs=1, participation=0.5, merge_alpha=0.5,
                      lr=0.03, afl_mode="fedavg", prox_mu=0.01,
                      server_lr=1.0, server_momentum=0.9, attack="none",
                      attack_fraction=0.25, attack_scale=1.0,
                      defense="none", clip_tau=10.0, codec="none",
                      topk_frac=0.1, quant_bits=8, telemetry=True,
                      engine="loop", serve=False, serve_qps=64.0,
                      serve_arrival="poisson", fault_profile="none",
                      churn_rate=0.3, quorum_frac=0.5, fault_mtd=False)
    direct = api.FederatedSimulation(fl, ds, device="cpu").run()
    want = _fl_metric_lines(direct)
    got = [x for x in _lines(text) if x in want]
    assert got == want
    assert r.round_train_loss == direct.round_train_loss


@pytest.mark.parametrize("argv,strategy,iid", [
    (["--strategy", "fedadam", "--rounds", "2", "--clients", "4",
      "--n-train", "400", "--engine", "vectorized", "--server-lr", "0.1"],
     "fedadam", True),
    (["--strategy", "afl", "--gossip", "--non-iid", "--rounds", "2",
      "--clients", "4", "--n-train", "400"], "afl", False),
])
def test_federated_twin_plugin_and_gossip_runs(argv, strategy, iid, capsys):
    r = fl_twin.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    for line in _fl_metric_lines(r, strategy, iid):
        assert line in _lines(text)
    assert np.isfinite(r.test_accuracy)


def test_federated_twin_scenario_prints_the_document(capsys):
    from repro_torch.core.scenarios import run_scenario

    doc = fl_twin.main(["--scenario", "iid-hfl-vec", "--device", "cpu"])
    text = capsys.readouterr().out
    start = text.index("\n{\n") + 1
    printed = json.loads(text[start:])
    assert printed == json.loads(json.dumps(doc))
    want = json.loads(json.dumps(run_scenario("iid-hfl-vec", device="cpu")))
    for key in want:
        if key in ("timing", "telemetry"):
            assert sorted(printed[key]) == sorted(want[key]), key
        else:
            assert printed[key] == want[key], key
    _assert_lines(text[:start], [r"phase breakdown \(host dispatch\):$"])


def test_serve_decode_twin_tokens_equal_greedy_generate(capsys):
    from repro_torch.models.decode import greedy_generate

    out = serve_twin.main(["--arch", "gemma3-4b", "--batch", "2",
                           "--prompt-len", "4", "--gen-len", "8",
                           "--device", "cpu"])
    text = capsys.readouterr().out
    toks = out["tokens"]
    _assert_lines(text, [r"arch=gemma3-4b  batch=2$",
                         r"prefill: 4 tokens in \d+\.\d\ds$",
                         r"decode:  8 steps in \d+\.\d\ds "
                         r"\(\d+\.\d ms/step/batch\)$",
                         re.escape(f"  seq[0]: {toks[0].tolist()}"),
                         re.escape(f"  seq[1]: {toks[1].tolist()}"),
                         r"cache index: 12 \(== 12 writes\)$"])
    want = greedy_generate(out["params"], out["cfg"], out["prompt"], 8)
    assert torch.equal(toks, want)
    assert out["index"] == 12


def test_serve_decode_twin_falls_back_from_modality_configs(capsys):
    out = serve_twin.main(["--arch", "seamless-m4t-large-v2", "--batch",
                           "1", "--prompt-len", "2", "--gen-len", "2",
                           "--device", "cpu"])
    text = capsys.readouterr().out
    _assert_lines(text, [r"seamless-m4t-large-v2 needs modality inputs; "
                         r"using phi3-mini instead$",
                         r"arch=phi3-mini-3.8b  batch=1$"])
    assert out["cfg"].name == "phi3-mini-3.8b"


def test_multipod_twin_runs_the_dry_run(tmp_path, capfd, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc = dry_twin.main(["--arch", "xlstm-125m", "--shape", "decode_32k"])
    text = capfd.readouterr().out
    assert rc == 0, text[-3000:]
    _assert_lines(text, [r"\+ .* -m repro_torch\.launch\.dryrun --mesh both "
                         r"--arch xlstm-125m --force --out .* --shape "
                         r"decode_32k$",
                         r"\[xlstm-125m x decode_32k x 16x16\]$",
                         r"  run=", r"  terms: ",
                         r"\[xlstm-125m x decode_32k x 2x16x16\]$"])
    outs = sorted(os.listdir(tmp_path / "repro_dryrun_demo"))
    assert outs == ["xlstm-125m_decode_32k_16x16.json",
                    "xlstm-125m_decode_32k_2x16x16.json"]
