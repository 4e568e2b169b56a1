"""The port's roofline and dry run held against the reference.

* ``roofline.report``: ``count_params``, ``model_flops`` and
  ``structural_memory_bytes`` equal the reference's exactly for every
  arch x shape x kind and both production meshes; ``Roofline.row()``
  equals the reference's once the port's three constants are set to the
  reference's (the reference is not edited).
* ``roofline.op_analysis``: exact FLOPs of one matmul, an L-iteration
  loop and a nested loop (the cases of ``tests/test_roofline.py``), and
  ``FlopCounterMode``'s count of the same calls; bytes of known
  operators; collective bytes of an all-reduce, an all-gather, a
  reduce-scatter and a DTensor redistribution on a fake group of four
  ranks, in a child process (a process has one default group). A smoke
  dense train step's FLOPs equal ``train_smoke.step_flops``
  (``projections`` + ``attention_computed``) and the reference's
  ``hlo_analysis.analyze`` of its one-device jit: measured equal, with
  and without ``dots`` remat, so the tolerance is none.
* ``launch.dryrun``: ``tinyllama-1.1b|train_4k|pod16x16`` in a child
  process (~10 s): status ``ok``, the reference's row keys, its
  ``model_flops_total`` and ``memory_model_bytes`` from the reference's
  formulas, rank 0's exact 1/16 share of the products under tensor
  parallelism with its temporaries under 80 GB, and ``roofline_table``
  on the result.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.benchmarks import roofline_table, train_smoke
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs
from repro_torch.launch import steps as tsteps
from repro_torch.models import convert
from repro_torch.models.config import SHAPES as TSHAPES
from repro_torch.roofline import op_analysis
from repro_torch.roofline import report as treport

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as rget
    from repro.models import model as rmodel
    from repro.models.config import get_shape as rget_shape
    from repro.roofline import hlo_analysis
    from repro.roofline import report as rreport
except ImportError:     # a machine with a card and no jax
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
KINDS = ("train", "prefill", "decode")


def _need_reference():
    if jax is None:
        pytest.skip("needs jax, the reference package's framework")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    return env


# ----------------------------------------------------------------- report


@pytest.mark.parametrize("arch", list_archs())
def test_report_formulas_equal_reference(arch):
    _need_reference()
    t, r = tget(arch), rget(arch)
    for active in (False, True):
        assert treport.count_params(t, active) == \
            rreport.count_params(r, active)
    for shape in TSHAPES:
        rshape = rget_shape(shape.name)
        for kind in KINDS:
            assert treport.model_flops(t, shape, kind) == \
                rreport.model_flops(r, rshape, kind)
            for mesh in MESHES:
                assert treport.structural_memory_bytes(
                    t, shape, kind, mesh) == \
                    rreport.structural_memory_bytes(r, rshape, kind, mesh)


ROOFLINES = [
    dict(arch="a", shape="s", mesh="m", chips=2, flops_per_device=197e12,
         bytes_per_device=819e9 / 2, collective_bytes_per_device=50e9 / 4,
         collective_breakdown={}, model_flops_total=2 * 197e12,
         memory_model_bytes=819e9 / 2),
    dict(arch="b", shape="t", mesh="pod16x16", chips=256,
         flops_per_device=3.1e14, bytes_per_device=7.5e12,
         collective_bytes_per_device=2.2e9,
         collective_breakdown={"all-gather": 1.5e8, "reduce-scatter": 2e9},
         model_flops_total=6.9e15, memory_model_bytes=0.0),
    dict(arch="c", shape="u", mesh="pod2x16x16", chips=512,
         flops_per_device=1e9, bytes_per_device=4e12,
         collective_bytes_per_device=9e12, collective_breakdown={},
         model_flops_total=1e11, memory_model_bytes=2e10),
]


@pytest.mark.parametrize("i", range(len(ROOFLINES)))
def test_roofline_row_equals_reference_with_its_constants(monkeypatch, i):
    _need_reference()
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(treport, name, getattr(rreport, name))
    assert treport.Roofline(**ROOFLINES[i]).row() == \
        rreport.Roofline(**ROOFLINES[i]).row()


def test_h100_constants():
    """NVIDIA H100 SXM5 80GB HBM3 (700 W) data-sheet figures."""
    assert (treport.PEAK_FLOPS, treport.HBM_BW, treport.ICI_BW) == (
        989e12, 3.35e12, 450e9)
    r = treport.Roofline(**ROOFLINES[0])
    assert r.compute_s == pytest.approx(197 / 989)
    assert r.dominant == "compute"


# ------------------------------------------------------------ op_analysis


def _flops_and_reference_count(fn, *args):
    _, stats = op_analysis.analyze(fn, *args)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return stats, fc.get_total_flops()


def test_single_matmul_flops_exact():
    a, b = torch.zeros(64, 32), torch.zeros(32, 48)
    stats, counted = _flops_and_reference_count(lambda: a @ b)
    assert stats.flops == 2 * 64 * 32 * 48 == counted
    assert stats.dot_count == 1


def test_loop_counts_every_iteration():
    n_layers, m, k = 5, 16, 32
    ws, x = torch.zeros(n_layers, k, k), torch.zeros(m, k)

    def f():
        y = x
        for w in ws:
            y = torch.tanh(y @ w)
        return y

    stats, counted = _flops_and_reference_count(f)
    assert stats.flops == n_layers * 2 * m * k * k == counted
    assert stats.dot_count == n_layers


def test_nested_loop_flops():
    l1, l2, m, k = 3, 4, 8, 16
    ws, x = torch.zeros(l1, k, k), torch.zeros(m, k)

    def f():
        y = x
        for w in ws:
            for _ in range(l2):
                y = torch.tanh(y @ w)
        return y

    stats, counted = _flops_and_reference_count(f)
    assert stats.flops == l1 * l2 * 2 * m * k * k == counted


def test_batched_products_and_backward_match_flop_counter():
    q = torch.randn(2, 4, 8, 16, requires_grad=True)
    w = torch.randn(16, 16, requires_grad=True)

    def f():
        s = torch.einsum("bhqd,bhkd->bhqk", q @ w, q)
        torch.nn.functional.linear(s, torch.ones(8, 8)).sum().backward()

    stats, counted = _flops_and_reference_count(f)
    assert stats.flops == counted > 0


def test_bytes_of_known_ops():
    a = torch.zeros(64, 32)
    b = torch.zeros(32, 48)
    _, st = op_analysis.analyze(lambda: a @ b)
    assert st.bytes_accessed == 4 * (64 * 32 + 32 * 48 + 64 * 48)
    _, st = op_analysis.analyze(lambda: a + 1.0)
    assert st.bytes_accessed == 4 * 64 * 32 * 2
    # views, detach and reshapes of contiguous tensors launch nothing; a
    # reshape that must copy counts the copy
    _, st = op_analysis.analyze(
        lambda: a.t().t().reshape(-1)[3:].unsqueeze(0).detach())
    assert st.bytes_accessed == 0 and st.flops == 0
    _, st = op_analysis.analyze(lambda: a.t().reshape(-1))
    assert st.bytes_accessed == 4 * 64 * 32 * 2
    # an expanded operand counts its storage
    v = torch.zeros(1, 32)
    _, st = op_analysis.analyze(lambda: a * v.expand(64, 32))
    assert st.bytes_accessed == 4 * (64 * 32 + 32 + 64 * 32)


def test_peak_bytes_counts_live_storages():
    x = torch.zeros(256)                    # 1 KiB, an input: not counted

    def f():
        y = x * 2.0                         # +1 KiB
        z = y + 1.0                         # +1 KiB (2 live)
        del y                               # -1 KiB
        w = z.view(16, 16) * 3.0            # +1 KiB (2 live)
        return w

    out, st = op_analysis.analyze(f)
    assert st.peak_bytes == 2 * 1024
    assert out.shape == (16, 16)


_COLLECTIVE_SCRIPT = r"""
import json, torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import dryrun
from repro_torch.roofline import op_analysis
dryrun.init_fake_group(4)
mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("d",))
x = torch.zeros(8, 16)

def collectives():
    dist.all_reduce(x)
    out = torch.empty(32, 16)
    dist.all_gather_into_tensor(out, x)
    shard = torch.empty(2, 16)
    dist.reduce_scatter_tensor(shard, x)
    d = DTensor.from_local(x, mesh, [Shard(0)], run_check=False)
    d.redistribute(mesh, [Replicate()]).to_local()

_, st = op_analysis.analyze(collectives)
print(json.dumps(st.collective_bytes))
"""


def test_collective_bytes_on_a_fake_group():
    proc = subprocess.run([sys.executable, "-c", _COLLECTIVE_SCRIPT],
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    sent = 8 * 16 * 4
    # the redistribution all-gathers the same local shard once more
    assert got == {"all-reduce": sent, "all-gather": 2 * sent,
                   "reduce-scatter": sent}


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_smoke_train_step_flops(remat):
    """The port's one-device step: its products as ``step_flops`` counts
    them, and the reference's HLO count of the same step."""
    cfg = dataclasses.replace(tget("tinyllama-1.1b", smoke=True), remat=remat)
    b, s = 2, 64
    params = convert.params_from_numpy(convert.numpy_params(cfg, 0), cfg,
                                       "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (b, s)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    _, stats = op_analysis.analyze(tsteps.loss_and_grads, cfg, params, batch)
    want = train_smoke.step_flops(cfg, b, s)
    assert stats.flops == want["projections"] + want["attention_computed"]
    if jax is None:
        return
    rcfg = dataclasses.replace(rget("tinyllama-1.1b", smoke=True),
                               remat=remat)
    rp = jax.tree.map(jnp.asarray, convert.numpy_params(cfg, 0))
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    txt = jax.jit(jax.value_and_grad(
        lambda p, bt: rmodel.train_loss(p, rcfg, bt), has_aux=True)).lower(
        rp, rb).compile().as_text()
    ref = hlo_analysis.analyze(txt)
    assert stats.flops == ref.flops
    assert stats.dot_count == ref.dot_count


# ---------------------------------------------------------------- dry run


def _reference_row_keys() -> dict:
    """The keys of the reference dry run's row (``run_cell``'s dict
    literal) and of its ``memory`` entry, read from its source."""
    path = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", None) == "row":
            keys = {k.value: v for k, v in zip(node.value.keys,
                                               node.value.values)}
            return {"row": set(keys), "memory": {
                k.value for k in keys["memory"].keys},
                "xla": {k.value for k in keys["xla_cost_analysis"].keys}}
    raise AssertionError("no row literal in the reference's dry run")


@pytest.fixture(scope="module")
def dry_cell(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dry") / "dryrun.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "train_4k", "--mesh", "single",
         "--out", out], env=_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as fh:
        return out, json.load(fh)


def test_dryrun_cell_matches_reference_keys_and_formulas(dry_cell):
    _need_reference()
    _, data = dry_cell
    row = data["tinyllama-1.1b|train_4k|pod16x16"]
    assert row["status"] == "ok", row
    keys = _reference_row_keys()
    assert set(row) == keys["row"]
    assert set(row["memory"]) == keys["memory"]
    assert keys["xla"] <= set(row["xla_cost_analysis"])
    assert row["xla_cost_analysis"]["flops_uncorrected"] is None
    r = row["roofline"]
    assert set(r) == set(rreport.Roofline(**ROOFLINES[0]).row())
    cfg, shape = rget("tinyllama-1.1b"), rget_shape("train_4k")
    assert r["model_flops_total"] == rreport.model_flops(cfg, shape, "train")
    assert r["memory_model_bytes"] == rreport.structural_memory_bytes(
        cfg, shape, "train", {"data": 16, "model": 16})
    assert (r["chips"], r["mesh"]) == (256, "pod16x16")


def test_dryrun_cell_counts(dry_cell):
    """Rank 0 computes its 16 rows of 4096 with its own 1/16 of every
    layer over "model" (tensor parallelism: heads, d_ff and the vocab
    split 16 ways), so it does exactly 1/16 of the products of 65,536
    tokens, and the useful ratio is above 0.6; FSDP shards are gathered
    a layer at a time, so its live temporaries stay under one card's 80
    GB. FSDP's gathers and reduce-scatters and Megatron's all-reduces are
    its collectives."""
    _, data = dry_cell
    row = data["tinyllama-1.1b|train_4k|pod16x16"]
    r = row["roofline"]
    cfg = tget("tinyllama-1.1b")
    work = train_smoke.step_flops(cfg, 16, 4096)
    assert r["flops_per_device"] == (work["projections"]
                                     + work["attention_computed"]) / 16
    assert r["useful_flops_ratio"] > 0.6
    assert set(r["collective_breakdown"]) == {"all-gather", "all-reduce",
                                              "reduce-scatter"}
    assert 80e9 > row["memory"]["temp_bytes"] > \
        row["memory"]["argument_bytes"] > 0
    assert row["hlo_dot_count"] > 0


def test_roofline_table_reads_the_dry_run(dry_cell, monkeypatch):
    path, _ = dry_cell
    monkeypatch.setattr(roofline_table, "RESULTS", path)
    rows = roofline_table.run()
    cell = "roofline/tinyllama-1.1b/train_4k/pod16x16"
    assert [name for name, _, _ in rows] == [
        f"{cell}/compute_s", f"{cell}/memory_s", f"{cell}/collective_s",
        f"{cell}/fraction"]
    assert rows[0][2] > 0
    assert "tinyllama-1.1b" in roofline_table.table()
    monkeypatch.setattr(roofline_table, "RESULTS", path + ".missing")
    assert roofline_table.run() == [
        ("roofline/missing-run-dryrun-first", 0.0, 0.0)]
