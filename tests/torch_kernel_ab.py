"""Card readings of B5 (`flash_attention`, bfloat16) and B1 (`fedavg_agg`)
of one checkout, for comparing two checkouts on one card in one call.
Not collected by pytest (no `test_` prefix); needs a CUDA card.

    python3 tests/torch_kernel_ab.py ROOT [ROOT ...]

For each ROOT (a checkout of the repository, e.g. a `git archive` of the
parent commit unpacked into a git-ignored directory, and `.`), one process
builds that checkout's kernels into its own `build/` and prints one line
`AB {json}`. The shapes, the gates and the timing are this checkout's
chip_smoke.py's (`flash_row` at every bfloat16 shape of `FLASH_MAIN`,
`fedavg_row` at N = 7900 float32 and C = 2, 4, 8, 32, 33, 64); only the
kernels and their wrappers come from ROOT. Run the roots in turns
(A, B, B, A) to see the spread of the card beside the difference.
"""
import json
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
from repro_torch.kernels import build

build.build_all(["flash_attention", "fedavg_agg"])
out = {"root": root, "card": cs._card_line()}
gen = torch.Generator().manual_seed(9)
for case in cs.FLASH_MAIN:
    row = cs.flash_row(case, torch.bfloat16, True, gen)
    row.pop("design")             # names this checkout's kernel, not ROOT's
    out[case[0]] = row
gen = torch.Generator().manual_seed(0)
for C in (2, 4, 8, 32, 33, 64):
    out[f"fedavg_agg C={C}"] = cs.fedavg_row(C, 7900, torch.float32, True,
                                             gen)
print("AB " + json.dumps(out), flush=True)
"""


def main(roots):
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        if not os.path.exists(os.path.join(root, "src", "repro_torch")):
            raise SystemExit(f"{root} is not a checkout of the repository")
        subprocess.run([sys.executable, "-c", CHILD, root, HERE], check=True,
                       timeout=600)


if __name__ == "__main__":
    main(sys.argv[1:])
