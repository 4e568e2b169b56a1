"""Fault tolerance: checkpoint/restart orchestration + failure injection.

The port of ``repro.runtime.fault``. The training driver is written as
resume-first: every invocation calls ``resume_or_init`` which restores the
newest complete checkpoint if one exists. Because the data pipeline is a
pure function of the step (``data/synthetic.py``), a killed-and-restarted
run replays the exact batch sequence — the tests kill a run mid-training
and assert the loss curve continues bitwise-identically.

``FailureInjector`` deterministically raises at a chosen step (simulating
a preemption/node loss) so the restart path is exercised in CI.

Where the reference learns what to restore into from ``jax.eval_shape``
of the init function, the port takes that structure as an argument: a
tree of ``meta`` tensors (``launch.steps.state_struct``), which holds no
memory, so a restart never builds a model's random weights only to
overwrite them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Tuple

from repro_torch import sharding
from repro_torch.checkpoint import ckpt


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises SimulatedFailure at `fail_at_step` (once; marker-file keyed
    so a restarted run does not re-fail)."""

    fail_at_step: Optional[int] = None
    marker_path: Optional[str] = None

    def check(self, step: int) -> None:
        if self.fail_at_step is None or step != self.fail_at_step:
            return
        if self.marker_path:
            if os.path.exists(self.marker_path):
                return          # already failed once; let the retry proceed
            with open(self.marker_path, "w") as f:
                f.write(str(step))
        raise SimulatedFailure(f"injected failure at step {step}")


def resume_or_init(ckpt_dir: str, init_fn: Callable[[], Any], target: Any,
                   device=None, mesh=None, placements=None
                   ) -> Tuple[Any, int]:
    """Restore the latest checkpoint or build fresh state.

    Returns (state, start_step). `init_fn` is only called when no
    checkpoint exists; otherwise the checkpoint is restored into the
    structure of `target` (tensors, or ``meta`` tensors giving shapes and
    dtypes) on `device`. With `mesh`, the state is laid out as DTensors
    with the tree of `placements` (the reference's ``shardings``).
    """
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        state = init_fn()
        if mesh is not None:
            state = sharding.distribute_tree(state, mesh, placements)
        return state, 0
    state = ckpt.restore(ckpt_dir, target, step=step, device=device,
                         mesh=mesh, placements=placements)
    return state, step
