"""Kernel tile-granularity benchmarks, the port of
``benchmarks/kernel_bench.py`` (the TPU warp-size analogue).

Sweeps the model's flash-attention KV chunk and SSD chunk length through
the model path (``models.attention.flash_attention``, ``models.ssm.
ssd_scan``), then times one call of each LM kernel through ``kernels.ops``
for the record: ``kernel/flash_attention`` (K5) and ``kernel/moe_gmm``
(K4) at the reference's record shapes, and ``kernel/ssd_scan`` (K6) at the
SSD sweep's shape, which is where K6's one-call time belongs (the
reference reaches K6 only through ``ops``). Each record call is preceded
by one untimed call, which builds the kernel on a card. Inputs come from
numpy seeds; every timed region starts and ends with a device
synchronise.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench [--device cpu]

prints ``name,us_per_call,derived`` rows (derived: GFLOP/s for the
attention sweep, the chunk length for the SSD sweep, 0 for the record).
On the CPU the kernel rows time the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import attention, ssm
from repro_torch.models.model import resolve_device

Row = Tuple[str, float, float]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn: Callable[[], object], device: torch.device,
          iters: int = 3) -> float:
    """Microseconds per call of `fn` over `iters` calls, after one warm-up
    call."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e6


def _normal(seed: int, shape, device, scale: float = 1.0) -> torch.Tensor:
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(device)


def attention_chunk_sweep(device="cuda", b: int = 2, s: int = 2048,
                          h: int = 4, hd: int = 64,
                          chunks: Sequence[int] = (128, 256, 512, 1024,
                                                   2048),
                          iters: int = 3) -> List[Row]:
    """kv_chunk granularity sweep for the model's scan-flash attention."""
    dev = resolve_device(device)
    q = _normal(0, (b, s, h, hd), dev)
    k = _normal(1, (b, s, h, hd), dev)
    v = _normal(2, (b, s, h, hd), dev)
    pos = torch.arange(s, device=dev)
    flops = 4.0 * b * h * s * s * hd / 2        # causal
    rows = []
    for chunk in chunks:
        us = _time(lambda c=chunk: attention.flash_attention(
            q, k, v, pos, pos, None, kv_chunk=c), dev, iters)
        rows.append((f"attn/kv_chunk={chunk}", us,
                     flops / (us * 1e-6) / 1e9))
    return rows


def ssd_chunk_sweep(device="cuda", b: int = 2, s: int = 4096, nh: int = 8,
                    p: int = 64, n: int = 64,
                    chunks: Sequence[int] = (64, 128, 256, 512),
                    iters: int = 3) -> List[Row]:
    """SSD chunk-length sweep (intra-chunk quadratic vs inter-chunk scan)."""
    dev = resolve_device(device)
    x = _normal(3, (b, s, nh, p), dev)
    dt = torch.zeros((b, s, nh), device=dev)
    a_log = torch.zeros((nh,), device=dev)
    d_skip = torch.ones((nh,), device=dev)
    bb = _normal(4, (b, s, 1, n), dev)
    cc = _normal(5, (b, s, 1, n), dev)
    rows = []
    for chunk in chunks:
        us = _time(lambda q=chunk: ssm.ssd_scan(x, dt, a_log, bb, cc,
                                                d_skip, chunk=q)[0],
                   dev, iters)
        rows.append((f"ssd/chunk={chunk}", us, float(chunk)))
    return rows


def ssd_inputs(device, bh: int = 16, s: int = 4096, p: int = 64,
               n: int = 64, seed: int = 9):
    """xdt (BH,S,P), da (BH,S) <= 0, b, c (BH,S,N), float32, from numpy
    seeds: the SSD sweep's shape (B 2 x nh 8 heads) by default."""
    dev = resolve_device(device)
    xdt = _normal(seed, (bh, s, p), dev, 0.5)
    da = -torch.nn.functional.softplus(_normal(seed + 1, (bh, s), dev))
    b = _normal(seed + 2, (bh, s, n), dev, 0.3)
    c = _normal(seed + 3, (bh, s, n), dev, 0.3)
    return xdt, da, b, c


def record_inputs(device="cuda", ssd_shape=(16, 4096, 64, 64)):
    """The record calls' arguments, from numpy seeds: ``{name: args}`` for
    ``ops.flash_attention`` (q = k = v, (2, 256, 64)), ``ops.moe_gmm``
    ((256, 128) x (4, 128, 128), every block on expert 0) and
    ``ops.ssd_scan`` (`ssd_shape`, (BH, S, P, N))."""
    dev = resolve_device(device)
    q = _normal(6, (2, 256, 64), dev)
    return {"flash_attention": (q, q, q),
            "moe_gmm": (_normal(7, (256, 128), dev),
                        _normal(8, (4, 128, 128), dev),
                        torch.zeros((2,), dtype=torch.int32, device=dev)),
            "ssd_scan": ssd_inputs(dev, *ssd_shape)}


def kernel_record(device="cuda", ssd_shape=(16, 4096, 64, 64),
                  ssd_chunk: int = 128) -> List[Row]:
    """One timed call per LM kernel through ``ops`` (record only): K5 and
    K4 at the reference's record shapes, K6 at `ssd_shape` (BH, S, P, N),
    the SSD sweep's by default, on :func:`record_inputs`."""
    dev = resolve_device(device)
    calls = {"flash_attention": ops.flash_attention, "moe_gmm": ops.moe_gmm,
             "ssd_scan": lambda *a: ops.ssd_scan(*a, chunk=ssd_chunk)}
    return [(f"kernel/{name}",
             _time(lambda f=calls[name], a=args: f(*a), dev, 1), 0.0)
            for name, args in record_inputs(dev, ssd_shape).items()]


def run(device="cuda") -> List[Row]:
    return (attention_chunk_sweep(device) + ssd_chunk_sweep(device)
            + kernel_record(device))


def main(argv=None) -> List[Row]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rows = run(args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.3f}")
    return rows


if __name__ == "__main__":
    main()
