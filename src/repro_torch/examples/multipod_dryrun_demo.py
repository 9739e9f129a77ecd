"""Multi-pod dry-run demo (twin of `examples/multipod_dryrun_demo.py`):
run one (arch x shape) on the single-pod (16x16 = 256) and multi-pod
(2x16x16 = 512) production meshes and print the roofline terms. The
dry-run runs rank 0's sharded step on the meta device
(`repro_torch.launch.dryrun`), so it touches no card; it runs in a
subprocess, as the reference's does.

    PYTHONPATH=src python -m repro_torch.examples.multipod_dryrun_demo \
        --arch yi-9b
"""
import argparse
import os
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def main(argv=None):
    """Run the dry-run CLI in a subprocess; returns its exit code (the
    command line `python -m` runs this under raises SystemExit with it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--fl", choices=["hfl", "afl", "cfl"],
                    help="dry-run the federated trainer instead")
    args = ap.parse_args(argv)

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
           "both", "--arch", args.arch, "--force", "--out",
           os.path.join(tempfile.gettempdir(), "repro_dryrun_demo")]
    if args.fl:
        cmd += ["--fl", args.fl]
    else:
        cmd += ["--shape", args.shape]
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    print("+", " ".join(cmd), flush=True)
    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    raise SystemExit(main())
