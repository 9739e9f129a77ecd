"""Card readings of two host-bound parts of chip_smoke.py's phase 13 in
two checkouts, for comparing them on one card in one call. Not collected by
pytest (no `test_` prefix); needs a CUDA card.

    python3 tests/torch_phase_ab.py PARENT_ROOT CHANGE_ROOT

Each ROOT is a checkout of the repository (e.g. a `git archive` of the
parent commit unpacked into a git-ignored directory, and `.`). 13(c)'s
eager FL rounds (`chip_smoke.fl_train_phase`: xlstm-125m cut to 4 layers,
HFL, AFL and CFL, 2 rounds each) run in a fresh process of each root in
turns, parent, change, change, parent; each prints one line
`AB fl_rounds {json}` (the phase's seconds and each round's). Then, in
CHANGE_ROOT, 13(b)'s model (zamba2-1.2b whole, bf16, remat, grad_accum 2,
AdamW, 4 x 2048) takes one eager step and its graphed train step is
captured four times, with 2, 1, 1 and 2 warm-up steps
(`make_graphed_train_step(warmup=)`), each capture deleted before the
next: `AB capture {json}`, the seconds of each. The first line is the
card's name and power limit.
"""
import json
import os
import subprocess
import sys

FL = """
import sys, time, json
sys.path[:0] = ['.', 'src']
import chip_smoke as cs
t = time.perf_counter()
out = cs.fl_train_phase('cuda')
print('AB fl_rounds ' + json.dumps({
    'seconds': time.perf_counter() - t,
    'rounds': {k: v['seconds_per_round'] for k, v in out.items()
               if isinstance(v, dict) and 'seconds_per_round' in v}}))
"""

CAPTURE = """
import sys, time, json
sys.path[:0] = ['.', 'src']
import torch
import chip_smoke as cs
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import MarkovLM
from repro_torch.launch.train import (device_batch, make_graphed_train_step,
                                      make_train_step)
from repro_torch.models.model import build_model
from repro_torch.optim import optimizers
cfg = get_config(cs.ZAMBA).with_updates(grad_accum=2)
model = build_model(cfg)
params = cs._card_init(model, 0, 'cuda')
lm = MarkovLM(cfg.vocab_size, seed=0)
b = device_batch(next(iter(lm.batches(4, 2048, 1, seed=0))), 'cuda')
opt = optimizers.adamw(3e-4, weight_decay=0.01)
st = opt.init(params)
step = make_train_step(model, opt, clip_norm=1.0)
params, st, _ = step(params, st, b)
torch.cuda.synchronize()
del step
out = {}
for i, w in enumerate((2, 1, 1, 2)):
    torch.cuda.synchronize()
    t = time.perf_counter()
    g = make_graphed_train_step(model, opt, params, st, b, clip_norm=1.0,
                                warmup=w)
    torch.cuda.synchronize()
    out[f'{i}:warmup{w}'] = time.perf_counter() - t
    del g
    torch.cuda.empty_cache()
print('AB capture ' + json.dumps(out))
"""


def _run(root, code, tag):
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith(tag)]
    if p.returncode or not lines:
        sys.stderr.write(p.stdout[-3000:] + p.stderr[-3000:])
        raise SystemExit(f"{root}: {tag} failed")
    return lines[-1]


def main(argv):
    if len(argv) != 2:
        raise SystemExit(__doc__)
    parent, change = (os.path.abspath(r) for r in argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name, root in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        line = _run(root, FL, "AB fl_rounds")
        rec = json.loads(line[len("AB fl_rounds "):])
        print("AB fl_rounds " + json.dumps(dict(rec, root=name)),
              flush=True)
    print(_run(change, CAPTURE, "AB capture"), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
