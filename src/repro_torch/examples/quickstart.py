"""Quickstart: the paper's result in a minute + a tiny LM training run.

The port of ``examples/quickstart.py``:

1. Runs the warp-size study (SW+ vs LW+ vs fixed warp sizes) on two
   benchmarks and prints the headline comparison (paper Figs. 5-7).
2. Trains a tiny decoder LM for 20 steps on the synthetic corpus and
   shows the loss falling.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List

from repro_torch.configs import get_config
from repro_torch.core.warpsim import machines, runner
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.data.loader import to_device
from repro_torch.launch import steps
from repro_torch.launch.train import init_state
from repro_torch.optim import adamw

STEPS = 20


def warp_size_study(device) -> None:
    print("=== Warp-size study (paper reproduction, 2 benchmarks) ===")
    suite = machines.paper_suite()
    res = runner.run_suite(suite, benches=("BKP", "MU"), device=device)
    for m in ("ws8", "ws32", "ws64", "SW+", "LW+"):
        row = " ".join(f"{b}:{res[m][b].ipc:6.2f}" for b in res[m])
        print(f"  {m:4s} IPC  {row}")
    print("  -> BKP (coalescing-hungry) prefers large warps; MU "
          "(divergent) prefers SW+ — the paper's central tension.\n")


def tiny_training_run(device) -> List[float]:
    print("=== Tiny LM training (tinyllama-family smoke config) ===")
    cfg = get_config("tinyllama-1.1b", smoke=True)
    state = init_state(cfg, 0, device)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=STEPS)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=64, global_batch=4))
    step = steps.make_train_step(cfg, opt_cfg)
    losses = []
    for i in range(STEPS):
        state, metrics = step(state, to_device(data.batch_at(i), device))
        losses.append(float(metrics["loss"]))
        if i % 5 == 0 or i == STEPS - 1:
            print(f"  step {i:3d} loss {losses[-1]:.4f}")
    print()
    return losses


def main(argv=None) -> List[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    warp_size_study(args.device)
    losses = tiny_training_run(args.device)
    print("done — see repro_torch.examples.warpsize_study for the full "
          "suite and repro_torch.examples.serve_batched for the serving "
          "path.")
    return losses


if __name__ == "__main__":
    main()
