"""Ungated card readings of B5's float32 kernel (`flash_attention`) and B2
(`trimmed_mean_agg`) in several checkouts, for ablations: variants of a
kernel copied under a git-ignored directory (e.g. `build/<name>`) and
edited there, some of which break the arithmetic on purpose to time a
piece of it (one TF32 product instead of three). Not collected by pytest
(no `test_` prefix); needs a CUDA card.

    python3 tests/torch_kernel_probe.py ROOT [ROOT ...]

For each ROOT, one process builds that checkout's two kernels into its
own `build/` and prints one line `PROBE {json}`: nvcc's register lines,
B5 float32 at every `FLASH_MAIN` shape (CUDA-graph time, max |out -
plain|) and its max error at every `FLASH_EDGE` shape, and B2 at the
`TRIM_MAIN` shapes (CUDA-graph time, whether its output equals the plain
version's bits). Inputs, shapes and timing are this checkout's
chip_smoke.py's; nothing is held to a gate, so use tests/torch_kernel_ab.py
for any reading that a design rests on.
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys
root, here = sys.argv[1], sys.argv[2]
sys.path[:0] = [root + "/src", here]
import torch
import chip_smoke as cs
from repro_torch.kernels import build, flash_attention as fl
from repro_torch.kernels import robust_agg as ra

names = ("flash_attention", "trimmed_mean_agg")
build.build_all(names)
out = {"root": root, "card": cs._card_line()}
for name in names:
    log = build.build_log(name).splitlines()
    out["ptxas " + name] = [l.strip() for l in log
                            if "registers" in l or "spill" in l]


def qkv(case, gen):
    label, B, S, T, H, Hk, d, causal, window = case
    return [torch.randn(shape, generator=gen).cuda()
            for shape in ((B, S, H, d), (B, T, Hk, d), (B, T, Hk, d))]


gen = torch.Generator().manual_seed(9)
for case in cs.FLASH_MAIN + cs.FLASH_EDGE:
    causal, window = case[7], case[8]
    q, k, v = qkv(case, gen)
    run = lambda: fl.flash_attention(q, k, v, causal=causal, window=window)
    err = float((run() - fl.flash_attention_torch(
        q, k, v, causal=causal, window=window)).abs().max())
    row = {"max_abs_err": err}
    if case in cs.FLASH_MAIN:
        row["graph_ms"] = cs._graph_ms(run, inner=3, samples=5)
    out["flash f32 " + case[0]] = row
    del q, k, v
    torch.cuda.empty_cache()
gen = torch.Generator().manual_seed(1)
for C, N, trim in cs.TRIM_MAIN:
    x = torch.randn((C, N), generator=gen).cuda()
    same = torch.equal(ra.trimmed_mean_agg(x, trim),
                       ra.trimmed_mean_torch(x, trim))
    out[f"trimmed C={C} trim={trim}"] = {
        "graph_us": 1e3 * cs._graph_ms(lambda: ra.trimmed_mean_agg(x, trim)),
        "equal_plain_bits": bool(same)}
print("PROBE " + json.dumps(out), flush=True)
"""


def main(argv):
    if not argv:
        raise SystemExit(__doc__)
    failed = []
    for root in argv:
        if not os.path.exists(os.path.join(root, "src", "repro_torch")):
            raise SystemExit(f"{root} is not a checkout of the repository")
        done = subprocess.run([sys.executable, "-c", CHILD, root, HERE],
                              timeout=900, capture_output=True, text=True)
        sys.stdout.write(done.stdout)
        sys.stdout.flush()
        if done.returncode != 0:
            sys.stderr.write(done.stderr)
            failed.append(root)
    if failed:
        raise SystemExit(f"probe failed in {failed}")


if __name__ == "__main__":
    main(sys.argv[1:])
