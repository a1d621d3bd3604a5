"""Process-parallel fan-out for any preprocessing CLI (the twin of
scp_tpu/tools/multi_preproc.py; reference
data_preproc/multi_data_preprocess.py): N copies of a command, the i-th
given `--parts i/N`.

    python -m scp_tpu_torch.tools.multi_preproc 8 \
        python -m scp_tpu_torch.tools.preprocess --type kitti --ori_dir ... --out_dir ...

Waits for every copy; exits non-zero when one of them did (128 + the
signal's number for a copy a signal killed, as a shell reports it).
"""

from __future__ import annotations

import subprocess
import sys


def commands(splits: int, cmd: list[str]) -> list[list[str]]:
    return [cmd + ["--parts", f"{i}/{splits}"] for i in range(splits)]


def main(argv=None) -> int:
    """Runs the copies at once; returns the first non-zero exit code, or 0."""
    argv = argv if argv is not None else sys.argv[1:]
    splits, cmd = int(argv[0]), list(argv[1:])
    print("start:", cmd, flush=True)
    procs = []
    try:
        for c in commands(splits, cmd):
            procs.append(subprocess.Popen(c))
        codes = [p.wait() for p in procs]
    finally:  # an interrupted fan-out leaves no copy running
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print("finished:", cmd, "exit codes", codes, flush=True)
    # Popen gives a copy killed by signal s the code -s
    return next((128 - c if c < 0 else c for c in codes if c), 0)


if __name__ == "__main__":
    sys.exit(main())
