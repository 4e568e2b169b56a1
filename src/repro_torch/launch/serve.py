"""Serving driver: batched decode with slot-based continuous batching.

The port of ``repro.launch.serve``. A fixed pool of `slots` decode slots
runs one fused ``decode_step`` per iteration. Finished or empty slots are
refilled from the request queue (continuous batching): each refill
prefills the new prompt and splices its KV/state cache into the slot.

The reference's behaviour is kept exactly, quirks included, so the two
generate the same tokens:

* one global cursor ``index``, set to the largest slot position before
  each decode step; empty slots still decode (their last token) and still
  go through routing;
* ``_splice_cache`` copies only arrays of rank >= 3 (the layer-stacked
  k/v, and the SSM's conv_x, conv_bc and h), so the cache's ``positions``
  vector is not taken from the prefill and decode does not attend to the
  prompt.

On the card, a MoE config with ``moe_dispatch="sw_plus"`` runs K3 once
and K4 three times per layer of every prefill and decode step. The
``ssm`` and ``hybrid`` families launch no kernel of the port, as the
reference's model path reaches no Pallas kernel there.

Demo on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models import model as model_lib


class Request:
    def __init__(self, rid: int, prompt: np.ndarray, max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.generated: List[int] = []
        self.done = False


def make_requests(cfg, n: int, max_new: int, seed: int = 0
                  ) -> List[Request]:
    """`n` requests with prompts drawn as the reference's ``main`` draws
    them: lengths in [4, 32) and tokens in [0, vocab) from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=rng.integers(4, 32)).astype(np.int32),
                    max_new)
            for i in range(n)]


def _splice_cache(pool_cache: dict, req_cache: dict, slot: int) -> dict:
    """Copy a single-sequence prefill cache into batch slot `slot` of the
    pool (in place; the pool is returned)."""
    for key, pool in pool_cache.items():
        single = req_cache[key]
        if isinstance(pool, dict):
            _splice_cache(pool, single, slot)
        elif (isinstance(pool, torch.Tensor) and pool.dim() >= 3
              and single.dim() == pool.dim()
              and single.shape[0] == pool.shape[0]):
            # (L, B, ...) layer-stacked per-sequence state
            pool[:, slot] = single[:, 0]
    return pool_cache


class BatchedServer:
    """Slot-based continuous batching around prefill/decode_step."""

    def __init__(self, cfg, params, slots: int, max_len: int,
                 device="cuda"):
        self.device = model_lib.resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"server on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.active: List[Optional[Request]] = [None] * slots
        self.cache = model_lib.init_decode_cache(cfg, slots, max_len,
                                                 self.device)
        # Per-slot decode positions (the fused cache keeps one global
        # cursor; per-slot masking uses slot positions).
        self.slot_pos = np.zeros(slots, dtype=np.int64)
        self._decode = (
            lambda p, t, c: model_lib.decode_step(p, self.cfg, t, c))
        self._prefill = (
            lambda p, b: model_lib.prefill(p, self.cfg, b, self.max_len))

    def _admit(self, req: Request, slot: int) -> int:
        tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.int64,
                                 device=self.device)
        logits, rcache = self._prefill(self.params, {"tokens": tokens})
        self.cache = _splice_cache(self.cache, rcache, slot)
        self.active[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        return int(torch.argmax(logits[0]))

    @torch.no_grad()
    def run(self, requests: List[Request]) -> dict:
        """Serve `requests` to the end. Runs without autograd, so weights
        that require grad (after training) serve as they are."""
        queue = list(requests)
        next_tokens = np.zeros(self.slots, dtype=np.int32)
        t0 = time.perf_counter()
        steps = 0
        while queue or any(r is not None for r in self.active):
            # Refill free slots.
            for s in range(self.slots):
                if self.active[s] is None and queue:
                    req = queue.pop(0)
                    first = self._admit(req, s)
                    req.generated.append(first)
                    next_tokens[s] = first
            if not any(r is not None for r in self.active):
                break
            # One fused decode step for all slots.
            toks = torch.as_tensor(next_tokens[:, None], dtype=torch.int64,
                                   device=self.device)
            if "kv" in self.cache:
                # Align the global cursor with the max slot position; the
                # position mask makes shorter slots correct.
                self.cache["kv"]["index"] = int(self.slot_pos.max())
            logits, self.cache = self._decode(self.params, toks, self.cache)
            steps += 1
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for s, req in enumerate(self.active):
                if req is None:
                    continue
                req.generated.append(int(nxt[s]))
                next_tokens[s] = int(nxt[s])
                self.slot_pos[s] += 1
                if len(req.generated) >= req.max_new:
                    req.done = True
                    self.active[s] = None
        dt = time.perf_counter() - t0     # each step waited on its argmax
        total_tokens = sum(len(r.generated) for r in requests)
        return {"requests": len(requests), "decode_steps": steps,
                "total_new_tokens": total_tokens,
                "tokens_per_s": total_tokens / max(dt, 1e-9),
                "wall_s": dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    params = model_lib.init_params(cfg, args.seed, args.device)
    reqs = make_requests(cfg, args.requests, args.max_new, args.seed)
    server = BatchedServer(cfg, params, args.slots, args.max_len,
                           device=args.device)
    stats = server.run(reqs)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
