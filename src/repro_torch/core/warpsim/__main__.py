"""Run the paper's warp-size study and print its headline table.

    PYTHONPATH=src python -m repro_torch.core.warpsim [--seeds 0,1,2]
    PYTHONPATH=src python -m repro_torch.core.warpsim --device cpu

The study runs on the card (the family kernels) unless ``--device cpu``
asks for the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.warpsim import api


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.warpsim",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated workload seeds (default 0)")
    args = ap.parse_args(argv)
    seeds = tuple(int(s) for s in args.seeds.split(","))
    study = api.Study(seeds=seeds)
    dev = torch.device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    t0 = time.perf_counter()
    res = api.Session(device=dev).run(study)
    wall = time.perf_counter() - t0
    print(f"{len(res)} cells on {name} ({res.stats['family_launches']} "
          f"family launches) in {wall:.3f} s")
    for metric, value in res.bands().items():
        print(f"  {metric:40s} mean {value['mean']:.4f}  "
              f"[{value['min']:.4f}, {value['max']:.4f}]")


if __name__ == "__main__":
    main()
