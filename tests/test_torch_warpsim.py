"""The PyTorch/CUDA port (``repro_torch``) held against the JAX reference.

Both packages see the same inputs, made from seeds; data passes between
them as numpy arrays. Every comparison is exact (``==``, no tolerance):
the timing model is IEEE-754 double arithmetic in a fixed order, and every
reference engine is bit-identical to every other.

* Import isolation: the port imports neither jax nor anything of ``repro``.
* Host stages: ThreadTrace / WarpStream columns equal the reference's.
* Plain kernels (``prep_ref`` + ``simulate_family_ref``) equal the
  reference family launch (Pallas, interpreted on the CPU) and the C core.
* The CUDA source's recurrence, built for the host with g++, equals the
  C core.
* The slice end to end: Session/Study records equal the reference's.
* ``gpu``-marked tests run the kernels against their plain versions on a
  card and skip without one:
  ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_warpsim.py``.

Regenerate the reference grid file (records of the paper grid, seeds
0-2, from the reference's ``native`` engine) with
``PYTHONPATH=src:tests python tests/test_torch_warpsim.py --write-grid``.
"""

import ast
import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.warpsim import _native, _pallas
from repro.core.warpsim import api as rapi
from repro.core.warpsim import divergence as rdiv
from repro.core.warpsim import machines as rmachines
from repro.core.warpsim.trace import Workload, get_workload
from repro_torch.core.warpsim import _cuda
from repro_torch.core.warpsim import api as tapi
from repro_torch.core.warpsim import config as tconfig
from repro_torch.core.warpsim import convert
from repro_torch.core.warpsim import divergence as tdiv
from repro_torch.core.warpsim import trace as ttrace
from repro_torch.core.warpsim import timing as ttiming
from test_golden import (
    GOLDEN_BENCHES, N_THREADS, _machine_strategy_draw, _program_strategy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
GRID_FILE = os.path.join(PORT, "core", "warpsim", "data",
                         "paper_grid_seeds012.json")
_TRACE_FIELDS = ("ev_kind", "ev_mask", "ev_arg", "ev_addr", "masks",
                 "addr_off", "addr_vals")

try:
    import hypothesis as hyp
    import hypothesis.strategies as hyp_st
except ImportError:
    hyp = None


# ---------------------------------------------------------------- helpers


def _port_cfg(cfg) -> tconfig.MachineConfig:
    return tconfig.MachineConfig(**dataclasses.asdict(cfg))


def _port_stream(stream) -> tdiv.WarpStream:
    return convert.stream_from_arrays(
        {f: getattr(stream, f) for f in convert.FIELDS})


def _family_pairs(wl, cfgs):
    """Reference and port ``(stream, cfg)`` pairs of one trace family:
    one reference stream per expansion key, carried over to the port
    through ``convert.stream_from_arrays``."""
    trace = rdiv.build_thread_trace(wl)
    ref, port, seen = [], [], {}
    for cfg in cfgs:
        key = cfg.expansion_key()
        if key not in seen:
            s = rdiv.aggregate_stream(trace, cfg)
            seen[key] = (s, _port_stream(s))
        ref.append((seen[key][0], cfg))
        port.append((seen[key][1], _port_cfg(cfg)))
    return ref, port


def _native_loops(ref_pairs):
    out = []
    for s, cfg in ref_pairs:
        loop = _native.run_scheduling_loop(
            s.n_warps, s.op_start, s.issue, s.kind, s.blk_off, s.blk_len,
            s.blocks, s.nbytes, cfg)
        assert loop is not None, "reference C core unavailable"
        out.append(loop)
    return out


def _odd_suite():
    """Non-power-of-two state: 3 SMs, 5 controllers, 3-way, 7-set L1."""
    kw = dict(num_sms=3, num_mem_ctrls=5, l1_ways=3,
              l1_size_bytes=64 * 3 * 7)
    return [rmachines.baseline(16, **kw), rmachines.sw_plus(**kw),
            rmachines.lw_plus(**kw)]


# ---------------------------------------------------- (a) import isolation

_BLOCKER = r"""
import importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(m.name)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print("ok")
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _sources():
    for root, _dirs, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax_or_repro():
    for path in _sources():
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    path, node.lineno, name)


# ------------------------------------------------------ (b) host stages


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bench", GOLDEN_BENCHES)
def test_host_stages_match_reference(bench, seed):
    ref_wl = get_workload(bench, n_threads=N_THREADS, seed=seed)
    port_wl = ttrace.get_workload(bench, n_threads=N_THREADS, seed=seed)
    ref_tr = rdiv.build_thread_trace(ref_wl)
    port_tr = tdiv.build_thread_trace(port_wl)
    assert port_tr.n_threads == ref_tr.n_threads
    for f in _TRACE_FIELDS:
        a, b = getattr(port_tr, f), getattr(ref_tr, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for mname, cfg in rmachines.paper_suite().items():
        ref_s = rdiv.aggregate_stream(ref_tr, cfg)
        port_s = tdiv.aggregate_stream(port_tr, _port_cfg(cfg))
        assert port_s.n_warps == ref_s.n_warps
        for f in convert.FIELDS:
            assert np.array_equal(getattr(port_s, f), getattr(ref_s, f)), (
                mname, f)


# ---------------------------------- (c) plain kernels vs the reference


@pytest.mark.parametrize("bench", GOLDEN_BENCHES)
def test_plain_family_matches_pallas_and_native(bench):
    wl = get_workload(bench, n_threads=N_THREADS)
    ref, port = _family_pairs(wl, rmachines.paper_suite().values())
    want = _pallas.run_family(ref)
    assert want is not None, "reference Pallas launch unavailable"
    assert want == _native_loops(ref)
    assert _cuda.run_family(port, device="cpu") == want


def test_plain_family_matches_native_on_odd_geometry():
    wl = get_workload("BFS", n_threads=256)
    ref, port = _family_pairs(wl, _odd_suite())
    assert _cuda.run_family(port, device="cpu") == _native_loops(ref)


if hyp is None:
    @pytest.mark.skip(reason="optional dep: property test needs hypothesis")
    def test_plain_family_matches_reference_on_random_workloads():
        pass
else:
    @hyp.given(
        program=_program_strategy(),
        cfg=hyp_st.composite(_machine_strategy_draw)(),
        n_warp_groups=hyp_st.sampled_from([4, 8, 16]),
        seed=hyp_st.integers(0, 2**31 - 1),
    )
    @hyp.settings(max_examples=4, deadline=None, database=None,
                  suppress_health_check=[hyp.HealthCheck.too_slow])
    def test_plain_family_matches_reference_on_random_workloads(
            program, cfg, n_warp_groups, seed):
        """One family of three units sharing the drawn stream: the drawn
        machine, its ideal-coalescing twin and an odd geometry."""
        wl = Workload("HYP", program,
                      n_threads=cfg.warp_size * n_warp_groups, seed=seed)
        cfgs = [cfg,
                dataclasses.replace(cfg, name="twin",
                                    ideal_coalescing=not cfg.ideal_coalescing),
                dataclasses.replace(cfg, name="odd", num_sms=3,
                                    num_mem_ctrls=5, l1_ways=3)]
        ref, port = _family_pairs(wl, cfgs)
        want = _native_loops(ref)
        assert _pallas.run_family(ref) == want
        assert _cuda.run_family(port, device="cpu") == want


# ------------------------------- (d) the CUDA source, built for the host


def _host_lib(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source for the host")
    so = str(tmp_path / "libwarpsim_host.so")
    src = os.path.join(PORT, "core", "warpsim", "csrc", "warpsim_host.cpp")
    proc = subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-o", so, src], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(so)
    lib.ws_host_family.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int64]
    lib.ws_host_family.restype = ctypes.c_int
    return lib


def _host_family(lib, fam):
    """Run the host build over a CPU family; scratch starts as garbage, so
    the recurrence must initialise every piece of state it reads."""
    n = fam.blocks.shape[0]
    ctrl = torch.full((n,), -7, dtype=torch.int64)
    si = torch.full((n,), -7, dtype=torch.int64)
    ssvc = torch.full((n,), float("nan"), dtype=torch.float64)
    fscr = torch.full((max(fam.fscr_len, 1),), float("nan"),
                      dtype=torch.float64)
    iscr = torch.full((max(fam.iscr_len, 1),), -7, dtype=torch.int64)
    cycles = torch.empty(fam.n_units, dtype=torch.float64)
    counts = torch.empty((fam.n_units, 3), dtype=torch.int64)
    rc = lib.ws_host_family(*(t.data_ptr() for t in (
        fam.up, fam.fp, fam.next0, fam.end, fam.issue, fam.kind,
        fam.blk_off, fam.blk_len, fam.blocks, fam.nbytes, fam.slot, ctrl,
        si, ssvc, fscr, iscr, cycles, counts)), fam.n_units)
    assert rc == 0
    return (ctrl, si, ssvc), cycles, counts


def test_cuda_source_host_build_matches_native(tmp_path):
    lib = _host_lib(tmp_path)
    families = [(get_workload(b, n_threads=N_THREADS),
                 list(rmachines.paper_suite().values()))
                for b in GOLDEN_BENCHES]
    families.append((get_workload("MTM", n_threads=256), _odd_suite()))
    for wl, cfgs in families:
        ref, port = _family_pairs(wl, cfgs)
        fam = _cuda.marshal(
            [(_cuda.stream_cols(s), c) for s, c in port], device="cpu")
        prepped, cycles, counts = _host_family(lib, fam)
        for got, want in zip(prepped, _cuda.prep_ref(fam.up, fam.fp,
                                                     fam.blocks,
                                                     fam.nbytes)):
            assert torch.equal(got, want), wl.name
        loops = [(c, o, m, h) for c, (o, m, h) in zip(cycles.tolist(),
                                                      counts.tolist())]
        assert loops == _native_loops(ref), wl.name


# ------------------------------------------------ (e) the slice end to end


def test_study_records_match_reference():
    study = dict(benches=GOLDEN_BENCHES, n_threads=N_THREADS)
    ref = rapi.Session(backend=rapi.InProcessBackend(parallel=False)).run(
        rapi.Study(**study))
    got = tapi.Session(device="cpu").run(tapi.Study(**study, engine="torch"))
    assert [dataclasses.asdict(r) for r in got.records] == [
        dataclasses.asdict(r) for r in ref.records]
    assert got.stats["family_launches"] == 5
    assert got.stats["trace_families"] == 5
    assert got.stats["expansion_groups"] == ref.stats["expansion_groups"]
    assert got.summary() == ref.summary()
    assert got.bands() == ref.bands()
    assert dataclasses.asdict(got.by(machine="SW+", bench="BFS").records[0]) \
        == dataclasses.asdict(ref.by(machine="SW+", bench="BFS").records[0])
    assert {b: dataclasses.asdict(r) for b, r in got.per_bench("LW+").items()} \
        == {b: dataclasses.asdict(r) for b, r in ref.per_bench("LW+").items()}


def test_run_scheduling_loop_matches_native():
    cfg = rmachines.baseline(32)
    s = rdiv.expand_stream(get_workload("SR2", n_threads=256), cfg)
    got = _cuda.run_scheduling_loop(
        s.n_warps, s.op_start, s.issue, s.kind, s.blk_off, s.blk_len,
        s.blocks, s.nbytes, _port_cfg(cfg), device="cpu")
    assert got == _native_loops([(s, cfg)])[0]


def test_sweep_grouping_matches_reference():
    from repro.core.warpsim import sweep as rsweep
    from repro_torch.core.warpsim import machines as tmachines
    from repro_torch.core.warpsim import sweep as tsweep

    def coords(cells):
        return [(m, b, n, s) for m, _cfg, b, n, s in cells]

    ref = rsweep.SweepSpec(benches=GOLDEN_BENCHES, seeds=(0, 1)).cells()
    got = tsweep.SweepSpec(benches=GOLDEN_BENCHES, seeds=(0, 1)).cells()
    assert coords(got) == coords(ref)
    assert coords(tsweep.family_major_cells(got)) == coords(
        rsweep.family_major_cells(ref))
    assert tmachines.expansion_groups(tmachines.paper_suite()) == \
        rmachines.expansion_groups(rmachines.paper_suite())


def test_status_reports_launch_counts():
    _cuda.reset_launch_counts()
    st = _cuda.status()
    assert st["cuda_available"] == torch.cuda.is_available()
    assert st["launches"] == {k: 0 for k in _cuda.KERNELS}


def test_simulate_matches_reference_cell():
    from repro.core.warpsim.timing import simulate as rsimulate
    from repro_torch.core.warpsim.timing import simulate as tsimulate
    cfg = rmachines.sw_plus()
    s = rdiv.expand_stream(get_workload("DYN", n_threads=256), cfg)
    got = tsimulate("DYN", _port_stream(s), _port_cfg(cfg), device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(
        rsimulate("DYN", s, cfg, engine="event"))


# ---------------------------------------------- the reference grid file


def _encode_result(res) -> dict:
    return {k: v.hex() if isinstance(v, float) else v
            for k, v in dataclasses.asdict(res).items()}


def reference_grid_blob() -> dict:
    """The reference's records of the paper grid, seeds 0-2, default
    sizes, from its ``native`` engine (floats as ``float.hex()``)."""
    study = rapi.Study(seeds=(0, 1, 2), engine="native")
    res = rapi.Session(backend=rapi.InProcessBackend(parallel=False)).run(
        study)
    return {
        "study": {"benches": list(study.benches), "machines": "paper_suite",
                  "seeds": list(study.seeds), "n_threads": study.n_threads,
                  "engine": study.engine},
        "records": [{"machine": r.machine, "bench": r.bench, "seed": r.seed,
                     "n_threads": r.n_threads,
                     "result": _encode_result(r.result)}
                    for r in res.records],
    }


def write_grid_file(path: str = GRID_FILE) -> None:
    blob = reference_grid_blob()
    lines = ",\n".join(json.dumps(r, sort_keys=True)
                       for r in blob["records"])
    with open(path, "w", encoding="utf-8") as fh:
        fh.write('{"study": ' + json.dumps(blob["study"], sort_keys=True)
                 + ',\n"records": [\n' + lines + "\n]}\n")


def test_reference_grid_file_is_current():
    with open(GRID_FILE, encoding="utf-8") as fh:
        assert json.load(fh) == reference_grid_blob()


# ------------------------------------------------------ no fallback


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    s = tdiv.expand_stream(ttrace.get_workload("DYN", n_threads=64),
                           tconfig.MachineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cuda.run_family([(s, tconfig.MachineConfig())])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.Session().run(tapi.Study(benches=("DYN",), n_threads=64))


def test_engine_must_match_device():
    assert _cuda.resolve_engine("auto", "cpu") == "torch"
    assert _cuda.resolve_engine("auto", "cuda") == "cuda"
    with pytest.raises(ValueError, match="does not run"):
        _cuda.resolve_engine("cuda", "cpu")
    with pytest.raises(ValueError, match="does not run"):
        _cuda.resolve_engine("torch", "cuda")
    with pytest.raises(ValueError, match="unknown engine"):
        _cuda.resolve_engine("pallas", "cpu")


def test_engine_selects_the_path(monkeypatch):
    s = tdiv.expand_stream(ttrace.get_workload("DYN", n_threads=64),
                           tconfig.MachineConfig())
    pairs = [(s, tconfig.MachineConfig())]
    with pytest.raises(ValueError, match="does not run"):
        _cuda.run_family(pairs, device="cpu", engine="cuda")
    with pytest.raises(ValueError, match="does not run"):
        ttiming.simulate("DYN", s, tconfig.MachineConfig(), engine="cuda",
                         device="cpu")
    want = _cuda.run_family(pairs, device="cpu", engine="torch")
    calls = []
    plain = _cuda.simulate_family_ref
    monkeypatch.setattr(_cuda, "simulate_family_ref",
                        lambda *a: calls.append(1) or plain(*a))
    assert _cuda.run_family(pairs, device="cpu", engine="auto") == want
    assert calls == [1]


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _cuda.build()
    assert list(tmp_path.iterdir()) == []


def test_failed_launch_raises():
    class FakeLib:
        @staticmethod
        def ws_error_string(code):
            return b"invalid configuration argument"

    _cuda._check_launch(FakeLib, "ws_family_kernel", 0)
    with pytest.raises(RuntimeError, match="ws_family_kernel launch failed"):
        _cuda._check_launch(FakeLib, "ws_family_kernel", 9)


def test_stream_from_arrays_validates_columns():
    s = rdiv.expand_stream(get_workload("BFS", n_threads=64),
                           rmachines.baseline(32))
    cols = {f: getattr(s, f) for f in convert.FIELDS}
    port = convert.stream_from_arrays(cols)
    assert port.n_warps == s.n_warps and port.kind.dtype == np.int8
    for bad in ({k: v for k, v in cols.items() if k != "blocks"},
                dict(cols, issue=cols["issue"].astype(np.float64)),
                dict(cols, op_start=cols["op_start"][::-1].copy()),
                dict(cols, op_start=np.zeros(0, dtype=np.int64)),
                dict(cols, blk_len=cols["blk_len"] + len(cols["blocks"])),
                dict(cols, kind=np.full_like(cols["kind"], 3))):
        with pytest.raises(ValueError):
            convert.stream_from_arrays(bad)
    # Raw columns handed to the launch are checked the same way.
    with pytest.raises(ValueError, match="outside the block pool"):
        _cuda.run_scheduling_loop(
            s.n_warps, s.op_start, s.issue, s.kind, s.blk_off + 1,
            s.blk_len, s.blocks, s.nbytes, tconfig.MachineConfig(),
            device="cpu")


# --------------------------------------------------- (f) on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bench", GOLDEN_BENCHES)
def test_kernels_match_plain_versions_on_card(card, bench):
    wl = get_workload(bench, n_threads=N_THREADS)
    _ref, port = _family_pairs(wl, list(rmachines.paper_suite().values())
                               + _odd_suite())
    units = [(_cuda.stream_cols(s), c) for s, c in port]
    fam = _cuda.marshal(units, device=card)
    before = {k: _cuda.launch_count(k) for k in _cuda.KERNELS}
    prepped = _cuda.prep(fam)
    for got, want in zip(prepped, _cuda.prep_ref(fam.up, fam.fp, fam.blocks,
                                                 fam.nbytes)):
        assert torch.equal(got, want)
    cycles, counts = _cuda.simulate_family(fam, *prepped)
    torch.cuda.synchronize()
    cpu = _cuda.marshal(units, device="cpu")
    want_c, want_n = _cuda.simulate_family_ref(cpu, *_cuda.prep(cpu))
    assert torch.equal(cycles.cpu(), want_c)
    assert torch.equal(counts.cpu(), want_n)
    assert {k: _cuda.launch_count(k) - before[k] for k in _cuda.KERNELS} \
        == {k: 1 for k in _cuda.KERNELS}


@pytest.mark.gpu
def test_study_on_card_matches_cpu(card):
    study = tapi.Study(benches=GOLDEN_BENCHES, n_threads=N_THREADS)
    got = tapi.Session(device=card).run(dataclasses.replace(study,
                                                            engine="cuda"))
    want = tapi.Session(device="cpu").run(study)
    assert got.stats["family_launches"] == 5
    assert [dataclasses.asdict(r) for r in got.records] == [
        dataclasses.asdict(r) for r in want.records]


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-grid"]:
        write_grid_file()
        print(f"wrote {GRID_FILE}")
    else:
        sys.exit("usage: python tests/test_torch_warpsim.py --write-grid")
