"""chip_smoke.py's 13(c) federated rounds (xlstm-125m cut to 4 layers, its
sLSTM at its published position) in several checkouts, for comparing
them on one card in one call. Not collected by pytest (no `test_`
prefix).

    python3 tests/torch_fl_round_ab.py ROOT [ROOT ...]
    python3 tests/torch_fl_round_ab.py --ops ROOT [ROOT ...]

Each ROOT is a checkout of the repository (e.g. a `git archive` of the
parent commit unpacked into a git-ignored directory, and `.`). In a fresh
process of each root, in the order given, that root's
`chip_smoke.fl_train_phase` runs on the card and one line `AB fl {json}`
gives the root and each strategy's seconds a round. The first line is
the card's name and power limit. With `--ops` nothing runs on the card:
each root's one local step of the same model (forward and backward, on
the CPU) is profiled and its aten calls counted, all of them and those
of a model whose four blocks are mLSTMs, which leaves the sLSTM's share.
"""
import json
import os
import subprocess
import sys

RUN = """
import sys, json
sys.path[:0] = ['.', 'src', 'tests']
import chip_smoke as cs

if sys.argv[2] == 'ops':
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.device import generator
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models.model import build_model, synthetic_train_batch
    full = get_config(cs.XLSTM)
    layers = cs.FL_TRAIN_CUT['num_layers'][1]
    out = {}
    for label, pattern in (('model', full.block_pattern[:layers]),
                           ('mlstm_only', ('mlstm',) * layers)):
        cfg = full.with_updates(num_layers=layers,
                                block_pattern=tuple(pattern))
        model = build_model(cfg)
        params = model.init(generator(0), device='cpu')
        batch = synthetic_train_batch(generator(1), cfg, 2, 256,
                                      device='cpu')
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            value_and_grad(model.loss, params, batch)
        out[label] = sum(e.count for e in prof.key_averages()
                         if e.key.startswith('aten::'))
    print('AB ops ' + json.dumps({'root': sys.argv[1],
                                  'aten_calls_per_local_step': out}))
else:
    rows = cs.fl_train_phase()
    print('AB fl ' + json.dumps({'root': sys.argv[1], **{
        case: rows[case]['seconds_per_round']
        for case in ('hfl', 'afl', 'cfl')}}))
"""


def main():
    ops = sys.argv[1] == "--ops"
    if not ops:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(smi.stdout.strip(), flush=True)
    for root in sys.argv[1 + ops:]:
        script = os.path.join(os.path.abspath(root), "_fl_round_ab_run.py")
        with open(script, "w") as f:
            f.write(RUN)
        try:
            p = subprocess.run([sys.executable, script, root,
                                "ops" if ops else "card"],
                               cwd=root, capture_output=True, text=True)
        finally:
            os.remove(script)
        print("\n".join(ln for ln in p.stdout.splitlines()
                        if ln.startswith("AB ")), flush=True)
        if p.returncode:
            sys.stderr.write(p.stdout[-3000:] + p.stderr[-3000:])
            raise SystemExit(f"{root}: the rounds failed")


if __name__ == "__main__":
    main()
