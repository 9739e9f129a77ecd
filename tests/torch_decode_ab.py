"""Card readings of chip_smoke.py's 15(h) sharded decode cases in several
checkouts, for comparing them on one card in one call. Not collected by
pytest (no `test_` prefix); needs a CUDA card.

    python3 tests/torch_decode_ab.py [--serve] ROOT [ROOT ...]

Each ROOT is a checkout of the repository (e.g. a `git archive` of the
parent commit unpacked into a git-ignored directory, and `.`). In a fresh
process of each root, in the order given, 8 ranks sharing the card run
that root's `torch_sharded_cases.decode_cut` for each case of this
tree's `chip_smoke.CUT_DECODE_CASES` (full width cut in depth by this
tree's `chip_smoke._decode_cut_kw`, float32,
the config's shipped profile, weights and stand-in state drawn on the
card) and print one line a case, `AB decode {json}`: the root, the case,
the slowest rank's median seconds a step, and rank 0's collective bytes a
step, all-gathers alone and all kinds weighed as
`launch.roofline.collective_bytes` weighs them, and its calls a step by
name (gloo operations, and "card_exchange" for the gathers of a layer's
leaves made at once card to card). The first line is the card's name and
power limit. With `--serve` each root first builds its kernels and runs
its 15(c) (`chip_smoke.sharded_serve_phase`: zamba2 cut to 7 layers, the
kernel prefill and 16 decode steps under fsdp and tp) and prints `AB
serve {json}`, the slowest rank's decode seconds a step under each
profile beside one device's.

    python3 tests/torch_decode_ab.py --paths PAIRS SERVE_PAIRS

compares, in one world of this checkout, the host path of the gloo
collectives of CUDA tensors (`core.collectives.SMALL_GATHER_BYTES` as
shipped) with gloo's own path (the constant 0): PAIRS pairs of the
decode cases, each pair running both settings, the first pair off
first and then alternating, and in the first SERVE_PAIRS pairs 15(c)
too. Each line carries its setting ("host_path_bytes") and pair.
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

RUN = """
import sys, json, statistics, tempfile
sys.path[:0] = ['.', 'src', 'tests']
import numpy as np
import torch_sharded_cases as cases
from repro_torch.launch import mesh, roofline as rl


def serve(w, root, tag):
    import chip_smoke as cs
    rows = cs.sharded_serve_phase(w)
    print('AB serve ' + json.dumps({
        'root': root, **tag, **{p: {
            'decode_s_per_step': max(r['rank_decode_s_per_step']),
            'single_decode_s_per_step': r['single_decode_s_per_step']}
            for p, r in rows.items()}}), flush=True)


def decode(w, cuts, root, tag):
    for arch, kw, B, cap, start, (shape, names) in cuts:
        vocab = cases.build(arch, False, **kw).cfg.vocab_size
        tokens = np.random.default_rng(5).integers(0, vocab, (6, B))
        with tempfile.TemporaryDirectory() as tmp:
            outs = w.run(cases.decode_cut, arch, kw, shape, names, B,
                         cap, start, tokens, reduced=False, init='card',
                         out_dir=tmp)
        reps = [o[3] for o in outs]
        counts = reps[0]['collectives']
        steps = len(reps[0]['step_seconds'])
        print('AB decode ' + json.dumps({
            'root': root, **tag, 'arch': arch, 'mesh': shape, 'B': B,
            's_per_step': max(statistics.median(r['step_seconds'])
                              for r in reps),
            'all_gather_bytes_per_step':
                counts['kind_bytes'].get('all-gather', 0) / steps,
            'collective_bytes_per_step':
                rl.collective_bytes(counts)['total'] / steps,
            'calls_per_step': {k: v / steps for k, v
                               in counts['calls'].items()}}),
            flush=True)


def main():
    cuts, root, mode = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    with mesh.World(8, device='cuda', timeout=600) as w:
        w.run(cases.warm)
        if mode.startswith('paths'):
            pairs, serve_pairs = (int(x) for x in mode.split(':')[1:])
            on = w.run(cases.host_path_bytes, 0)[0]
            if serve_pairs:
                from repro_torch.kernels import build
                build.build_all()
            for p in range(pairs):
                for nbytes in ((0, on) if p % 2 == 0 else (on, 0)):
                    w.run(cases.host_path_bytes, nbytes)
                    tag = {'host_path_bytes': nbytes, 'pair': p}
                    if p < serve_pairs:
                        serve(w, root, tag)
                    decode(w, cuts, root, tag)
            return
        if mode == 'serve':
            from repro_torch.kernels import build
            build.build_all()
            serve(w, root, {})
        decode(w, cuts, root, {})


if __name__ == '__main__':
    main()
"""


def main():
    sys.path.insert(0, os.path.dirname(HERE))
    import chip_smoke as cs
    cuts = json.dumps([(arch, cs._decode_cut_kw(arch, layers), B, cap,
                        start, mesh)
                       for arch, layers, B, cap, start, mesh
                       in cs.CUT_DECODE_CASES])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    if sys.argv[1] == "--paths":
        jobs = [(".", "paths:%s:%s" % (sys.argv[2], sys.argv[3]))]
    else:
        serve = sys.argv[1] == "--serve"
        jobs = [(root, "serve" if serve else "-")
                for root in sys.argv[1 + serve:]]
    for root, mode in jobs:
        script = os.path.join(os.path.abspath(root), "_decode_ab_run.py")
        with open(script, "w") as f:
            f.write(RUN)
        try:
            p = subprocess.run([sys.executable, script, cuts, root, mode],
                               cwd=root, capture_output=True, text=True)
        finally:
            os.remove(script)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("AB ")]
        print("\n".join(lines), flush=True)
        if p.returncode:
            sys.stderr.write(p.stdout[-3000:] + p.stderr[-3000:])
            raise SystemExit(f"{root}: the decode cases failed")


if __name__ == "__main__":
    main()
