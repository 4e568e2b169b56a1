"""End-to-end serving example: batched requests through the slot-based
continuous-batching server.

The port of ``examples/serve_batched.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.launch import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    stats = serve.main(["--arch", "tinyllama-1.1b", "--smoke",
                        "--requests", "8", "--slots", "4",
                        "--max-new", "12", "--device", args.device])
    print(f"served {stats['requests']} requests in {stats['decode_steps']} "
          f"fused decode steps ({stats['tokens_per_s']:.1f} tok/s on "
          f"{args.device})")
    return stats


if __name__ == "__main__":
    main()
