"""Card readings of B5 (`flash_attention`, bfloat16 and float32), B1
(`fedavg_agg`), B2 (`trimmed_mean_agg`), B3 (`gossip_mix_agg`), B4
(`dequant_agg`) and B6 (`ssm_scan`) of one checkout, for comparing two checkouts on one card in
one call. Not collected by pytest (no `test_` prefix); needs a CUDA card.

    python3 tests/torch_kernel_ab.py [--kernels NAME,...] ROOT [ROOT ...]

For each ROOT (a checkout of the repository, e.g. a `git archive` of the
parent commit unpacked into a git-ignored directory, and `.`), one process
builds that checkout's kernels into its own `build/` and prints one line
`AB {json}`. The shapes, the gates and the timing are this checkout's
chip_smoke.py's (`flash_row` at every shape of `FLASH_MAIN`, in bfloat16
for flash_attention and in float32 for flash_attention_f32, `fedavg_row`
at N = 7900 float32 and C = 2, 4, 8, 32, 33, 64, `trimmed_row` at the
`TRIM_MAIN` shapes, `gossip_row` at the three `GOSSIP_MAIN` schedules,
`dequant_row` at the `DEQUANT_MAIN` shapes and `DEQUANT_STREAM`,
`ssm_row` at `SSM_MAIN` in bfloat16 and float32); only the kernels and
their wrappers come from ROOT. `--kernels` picks some of
flash_attention, flash_attention_f32, fedavg_agg, trimmed_mean_agg,
gossip_mix_agg, dequant_agg and ssm_scan (default: all). Run the roots in turns
(A, B, B, A) to see the spread of the card beside the difference. The
last lines, `AB gossip_bits {json}` and `AB trimmed_bits {json}`, say
whether every root's B3 outputs at the `GOSSIP_MAIN` shapes, and B2's at
the `TRIM_MAIN` shapes, are the same bits (a digest of each output, from
the same inputs).
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("flash_attention", "flash_attention_f32", "fedavg_agg",
           "trimmed_mean_agg", "gossip_mix_agg", "dequant_agg", "ssm_scan")
SOURCES = {"flash_attention": "flash_attention",
           "flash_attention_f32": "flash_attention",
           "fedavg_agg": "fedavg_agg", "trimmed_mean_agg": "trimmed_mean_agg",
           "gossip_mix_agg": "gossip_mix", "dequant_agg": "dequant_agg",
           "ssm_scan": "ssm_scan"}
BITS = {"gossip_mix_agg": "gossip_bits", "trimmed_mean_agg": "trimmed_bits"}

CHILD = r"""
import json, sys
root, here, kernels = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
sources = json.loads(sys.argv[4])
sys.path[:0] = [root + "/src", here]
import torch
import chip_smoke as cs
from repro_torch.kernels import build

build.build_all(sorted({sources[k] for k in kernels}))
out = {"root": root, "card": cs._card_line()}
for name, dtype, tag in (("flash_attention", torch.bfloat16, ""),
                         ("flash_attention_f32", torch.float32, " f32")):
    if name in kernels:
        gen = torch.Generator().manual_seed(9)
        for case in cs.FLASH_MAIN:
            row = cs.flash_row(case, dtype, True, gen)
            row.pop("design")     # names this checkout's kernel, not ROOT's
            out[case[0] + tag] = row
if "fedavg_agg" in kernels:
    gen = torch.Generator().manual_seed(0)
    for C in (2, 4, 8, 32, 33, 64):
        out[f"fedavg_agg C={C}"] = cs.fedavg_row(C, 7900, torch.float32,
                                                 True, gen)
if "trimmed_mean_agg" in kernels:
    gen = torch.Generator().manual_seed(1)
    for C, N, trim in cs.TRIM_MAIN:
        x = torch.randn((C, N), generator=gen).cuda()
        out[f"trimmed_mean_agg C={C} trim={trim}"] = cs.trimmed_row(
            x, trim, True)
if "gossip_mix_agg" in kernels:
    gen = torch.Generator().manual_seed(2)
    for C, N, label, (mtd, degree, rounds, ev) in cs.GOSSIP_MAIN:
        mix, alive = cs._schedule_mix(C, mtd, degree, rounds, ev)
        out[f"gossip_mix_agg {label}"] = cs.gossip_row(
            C, N, torch.float32, mix, alive, label, True, gen)
if "dequant_agg" in kernels:
    gen = torch.Generator().manual_seed(3)
    for C, N in cs.DEQUANT_MAIN + [cs.DEQUANT_STREAM]:
        row = cs.dequant_row(C, N, "", True, gen)
        row.pop("design")         # names this checkout's kernel, not ROOT's
        out[f"dequant_agg C={C} N={N}"] = row
if "ssm_scan" in kernels:
    gen = torch.Generator().manual_seed(10)
    for case in cs.SSM_MAIN:
        for dtype in (torch.bfloat16, torch.float32):
            out[f"ssm_scan {case[0]} {dtype}"] = cs.ssm_row(case, dtype,
                                                           True, gen)
print("AB " + json.dumps(out), flush=True)
"""


def main(argv):
    kernels = list(KERNELS)
    if argv[:1] == ["--kernels"]:
        kernels = argv[1].split(",")
        argv = argv[2:]
    if not argv or not set(kernels) <= set(KERNELS):
        raise SystemExit(__doc__)
    digests = {}
    for root in argv:
        if not os.path.exists(os.path.join(root, "src", "repro_torch")):
            raise SystemExit(f"{root} is not a checkout of the repository")
        done = subprocess.run(
            [sys.executable, "-c", CHILD, root, HERE, ",".join(kernels),
             json.dumps(SOURCES)],
            timeout=900, capture_output=True, text=True)
        sys.stderr.write(done.stderr)
        if done.returncode:
            sys.stdout.write(done.stdout)
            raise SystemExit(f"{root}: exit code {done.returncode}")
        for line in done.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("AB "):
                rows = json.loads(line[3:])
                for name in BITS:
                    digests.setdefault(name, {}).setdefault(
                        root, []).append(
                        {k: r["out_sha256"] for k, r in rows.items()
                         if k.startswith(name)})
    for name, label in BITS.items():
        if name not in kernels:
            continue
        by_root = digests[name]
        every = [d for runs in by_root.values() for d in runs]
        print(f"AB {label} " + json.dumps({
            "roots": list(by_root), "same_bits_everywhere":
                all(d == every[0] for d in every),
            "digests": by_root}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
