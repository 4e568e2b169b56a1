"""Fault-tolerance drill: train, die at step 12, restart, verify the loss
curve continues exactly where it left off (deterministic restorable data
+ atomic checkpoints).

The port of ``examples/train_resume.py``, through
``repro_torch.launch.train``. The checkpoints go to a fresh directory
under ``--work-dir`` (default: the system's temp directory), removed
after.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_resume [--device cpu]
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

from repro_torch.launch import train
from repro_torch.runtime.fault import SimulatedFailure


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--work-dir", default=None,
                    help="parent of the run's checkpoint directory")
    args = ap.parse_args(argv)
    d = tempfile.mkdtemp(prefix="repro_resume_", dir=args.work_dir)
    drill = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "24",
             "--batch", "4", "--seq-len", "64", "--ckpt-dir", d,
             "--ckpt-every", "6", "--log-every", "6", "--device",
             args.device]
    try:
        print("run 1 (will be killed at step 12):")
        try:
            train.main(drill + ["--fail-at", "12"])
        except SimulatedFailure as e:
            print(f"  !! {e}")
        print("run 2 (restarts from the last checkpoint):")
        out = train.main(drill)
        print(f"resumed and finished: final loss {out['last_loss']:.4f}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
