"""The PyTorch/CUDA port (``repro_torch``) held against the JAX reference.

Both packages see the same inputs, made from seeds; data passes between
them as numpy arrays. Every comparison is exact (``==``, no tolerance):
the timing model is IEEE-754 double arithmetic in a fixed order, and every
reference engine is bit-identical to every other.

* Import isolation: the port imports neither jax nor anything of ``repro``.
* Completeness: every top-level public name of every ``src/repro`` module
  has its counterpart in the port, but for the jax plumbing named in
  ``LEFT_OUT_MODULES`` / ``LEFT_OUT_NAMES``.
* Host stages: ThreadTrace / WarpStream columns equal the reference's.
* Plain kernels (``prep_ref`` + ``simulate_family_ref``) equal the
  reference family launch (Pallas, interpreted on the CPU) and the C core.
* The CUDA source's recurrence, built for the host with g++ (the host
  form of the warp's searches, K1 folded into K2's staging), equals the C
  core in both placements of K2's state, on the paper grid's seed-0
  families, the dense and simd32 sweeps' seed-0 families, on odd,
  16-SM and wider-than-32-way geometries and on V100-shaped families
  whose units pass 256 warps (K2's bands in memory); K1 alone
  equals ``prep_ref``; the multiply-high remainder equals Python's ``%``;
  the searches alone keep the tie rules.
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
from repro.core.warpsim.trace import BENCHMARKS, Workload, get_workload
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
# The service stack's modules, by name: each must be there and import.
for name in ("envcfg", "obs", "faults", "mesh", "work_queue", "service"):
    __import__("repro_torch.core.warpsim." + name)
# The training slice's modules, by name.
for name in ("data.synthetic", "data.loader", "optim.adamw",
             "checkpoint.ckpt", "runtime.fault", "runtime.straggler",
             "launch.steps", "launch.train"):
    __import__("repro_torch." + name)
# The roofline, dry-run, harness and examples slice's modules, by name.
for name in ("roofline.report", "roofline.op_analysis", "launch.dryrun",
             "benchmarks.roofline_table", "benchmarks.moe_dispatch_bench",
             "benchmarks.sweep_bench", "benchmarks.run",
             "benchmarks.harness_smoke", "examples.quickstart",
             "examples.serve_batched", "examples.train_resume",
             "examples.warpsize_study"):
    __import__("repro_torch." + name)
# The fleet smokes' modules, by name.
for name in ("chaos_smoke", "mesh_smoke", "obs_smoke"):
    __import__("repro_torch.benchmarks." + name)
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


# ------------------------------------------------- (a2) completeness

# What the port leaves out of the JAX package on purpose, each with its
# reason: the jax plumbing only. Modules by path under ``src/repro``;
# names as ``module path:name``.
LEFT_OUT_MODULES = {
    "compat.py": "jax version shims; the port imports no jax",
    "core/warpsim/_pallas.py": "the Pallas family program: K1/K2 in "
                               "_cuda.py and csrc/",
    "core/warpsim/lint.py": "warpsim-lint; tier-1 runs it over the port",
    "roofline/hlo_analysis.py": "reads jax HLO; the port's counterpart is "
                                "roofline/op_analysis.py",
}
LEFT_OUT_NAMES = {
    "sharding.py:to_named": "builds jax NamedShardings; the port's "
                            "counterpart is to_placements",
    "kernels/coalesced_gather.py:VMEM_BYTES_BUDGET": "a TPU VMEM budget",
    "kernels/flash_attention.py:NEG_INF": "a Pallas kernel's mask "
                                          "constant",
    "kernels/ops.py:ref": "the jax reference kernels' module; the port's "
                          "plain versions sit beside each kernel",
    "models/common.py:dense_init": "jax.random initialisers; the port's "
                                   "counterpart is the torch.Generator Init",
    "models/common.py:embed_init": "jax.random initialisers (as dense_init)",
    "models/common.py:split_keys": "jax.random key splitting (as "
                                   "dense_init)",
    "models/common.py:causal_window_mask": "a jnp mask helper of the jax "
                                           "attention",
    "models/model.py:Sharder": "the jax sharding callback; the port has it "
                               "as sharding.Sharder",
    "core/granularity.py:Mesh": "jax.sharding.Mesh",
    "core/granularity.py:P": "jax.sharding.PartitionSpec",
    "core/granularity.py:jax": "the jax module itself",
    "core/granularity.py:jnp": "the jax.numpy module itself",
}


def _public_names(path: str) -> set:
    """Top-level public names a module binds: functions, classes, and
    names assigned (alone or in a tuple) at module level."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                names.update(e.id for e in elts if isinstance(e, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_port_has_every_public_name_of_the_jax_package():
    """Every module of ``src/repro`` has its counterpart in the port with
    each of its top-level public names, but for the jax plumbing named in
    LEFT_OUT_MODULES / LEFT_OUT_NAMES; and every entry there is still
    missing from the port (a stale exception fails too)."""
    src = os.path.join(REPO, "src")
    missing, stale = [], []
    for root, _dirs, files in os.walk(os.path.join(src, "repro")):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            ref_path = os.path.join(root, name)
            rel = os.path.relpath(ref_path, os.path.join(src, "repro"))
            rel = rel.replace(os.sep, "/")
            port_path = os.path.join(PORT, rel)
            if rel in LEFT_OUT_MODULES:
                if os.path.exists(port_path):
                    stale.append(rel)
                continue
            if not os.path.exists(port_path):
                missing.append(rel)
                continue
            have = _public_names(port_path)
            for n in sorted(_public_names(ref_path) - have):
                if f"{rel}:{n}" not in LEFT_OUT_NAMES:
                    missing.append(f"{rel}:{n}")
            stale += [k for k in LEFT_OUT_NAMES
                      if k.split(":")[0] == rel and k.split(":")[1] in have]
    assert missing == [], f"the port lacks {missing}"
    assert stale == [], f"exceptions the port no longer needs: {stale}"
    assert all(LEFT_OUT_MODULES.values()) and all(LEFT_OUT_NAMES.values())


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


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source for the host")
    so = str(tmp_path_factory.mktemp("host") / "libwarpsim_host.so")
    src = os.path.join(PORT, "core", "warpsim", "csrc", "warpsim_host.cpp")
    proc = subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-o", so, src], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(so)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ws_host_family.argtypes = [ptr] * 15 + [i64]
    lib.ws_host_family.restype = ctypes.c_int
    lib.ws_host_prep.argtypes = [ptr] * 7 + [i64]
    lib.ws_host_prep.restype = ctypes.c_int
    lib.ws_host_mod.argtypes = [ptr, i64, i64, ctypes.c_uint64, i64, ptr]
    lib.ws_host_mod.restype = None
    i32 = ctypes.c_int
    lib.ws_host_pops.argtypes = [ptr, i32, ptr, i64, ptr]
    lib.ws_host_pops.restype = i64
    lib.ws_host_find_way.argtypes = [ptr, ptr, i32, i32, ctypes.c_double,
                                     ptr, ptr]
    lib.ws_host_find_way.restype = i32
    lib.ws_host_victim.argtypes = [ptr, i32]
    lib.ws_host_victim.restype = i32
    return lib


def _host_prep(lib, fam):
    """K1 alone over a CPU family, as ``ws_prep_kernel`` runs it."""
    n = fam.blocks.shape[0]
    ctrl = torch.full((n,), -7, dtype=torch.int64)
    si = torch.full((n,), -7, dtype=torch.int64)
    ssvc = torch.full((n,), float("nan"), dtype=torch.float64)
    assert lib.ws_host_prep(*(t.data_ptr() for t in (
        fam.up, fam.fp, fam.blocks, fam.nbytes, ctrl, si, ssvc)),
        fam.n_units) == 0
    return ctrl, si, ssvc


def _host_family(lib, fam, placement):
    """Run the host build of K2 (K1 folded in) over a CPU family in
    `placement` (``"global"``: every unit's state in the scratch;
    ``"shared"``: each unit's state carved from one buffer, as a block
    carves its shared memory). State starts as garbage, so the recurrence
    must initialise every piece of state it reads."""
    # 0x7ff8... is a NaN as a double and a large negative-free int.
    scratch = torch.full((max(fam.scratch_len, 1),), 0x7FF8DEAD7FF8DEAD,
                         dtype=torch.int64)
    shared = torch.full((max(fam.state_bytes // 8, 1),), 0x7FF8DEAD7FF8DEAD,
                        dtype=torch.int64)
    cycles = torch.empty(fam.n_units, dtype=torch.float64)
    counts = torch.empty((fam.n_units, 3), dtype=torch.int64)
    rc = lib.ws_host_family(*(t.data_ptr() for t in (
        fam.up, fam.fp, fam.next0, fam.end, fam.issue, fam.kind,
        fam.blk_off, fam.blk_len, fam.blocks, fam.nbytes, fam.slot,
        scratch)),
        shared.data_ptr() if placement == "shared" else None,
        cycles.data_ptr(), counts.data_ptr(), fam.n_units)
    assert rc == 0
    return cycles, counts


def _check_host_build(lib, wl, cfgs):
    """The host build equals the C core on one family, in both
    placements, and its K1 alone equals prep_ref; returns the family
    (marshalled on the CPU)."""
    ref, port = _family_pairs(wl, cfgs)
    fam = _cuda.marshal([(_cuda.stream_cols(s), c) for s, c in port],
                        device="cpu")
    want = _native_loops(ref)
    for got, exp in zip(_host_prep(lib, fam),
                        _cuda.prep_ref(fam.up, fam.fp, fam.blocks,
                                       fam.nbytes)):
        assert torch.equal(got, exp), wl.name
    for placement in _cuda.PLACEMENTS:
        cycles, counts = _host_family(lib, fam, placement)
        loops = [(c, o, m, h) for c, (o, m, h) in zip(cycles.tolist(),
                                                      counts.tolist())]
        assert loops == want, (wl.name, placement)
    return fam


def _smoke_odd_suite():
    """The three odd geometries of chip_smoke.py: 3/5 SMs, 3/5/7
    controllers, 3/5/6-way L1s."""
    return [rmachines.baseline(16, num_sms=3, num_mem_ctrls=5, l1_ways=3,
                               l1_size_bytes=64 * 3 * 7),
            rmachines.sw_plus(num_sms=5, num_mem_ctrls=3, l1_ways=5,
                              l1_size_bytes=64 * 5 * 11),
            rmachines.lw_plus(num_sms=3, num_mem_ctrls=7, l1_ways=6,
                              l1_size_bytes=64 * 6 * 13)]


def _sixteen_sm_suite():
    """The paper's unscaled machine: 16 SMs (196 KB of L1 state alone)."""
    return [rmachines.baseline(32, num_sms=16), rmachines.sw_plus(num_sms=16)]


def _wide_way_suite():
    """L1s of more than 32 ways: the searches loop over groups of 32."""
    return [rmachines.baseline(8, l1_ways=40, l1_size_bytes=64 * 40 * 3),
            rmachines.sw_plus(l1_ways=72, l1_size_bytes=64 * 72 * 2),
            rmachines.lw_plus(l1_ways=33, l1_size_bytes=64 * 33 * 5)]


def _divisor_constants(d):
    """``(m, l)`` of the multiply-high remainder, computed here apart
    from ``_cuda.divisor_constants``: the least l with 2**l >= d, and m =
    ceil(2**(63 + l) / d)."""
    l = 0
    while (1 << l) < d:
        l += 1
    q, r = divmod(1 << (63 + l), d)
    return q + (r != 0), l


_DIVISORS = [1, 2, 3, 6, 7, 64, 96, 97, 1024, 2 ** 31 - 1]


@pytest.mark.parametrize("d", _DIVISORS)
def test_host_mod_matches_python_mod(host_lib, d):
    """``ws_mod`` (the host form of the card's multiply-high) equals
    Python's ``%`` over the whole range of non-negative int64 block ids,
    and its constants need no 65th bit: m < 2**64 and m d lies within
    2**l above 2**(63 + l), the condition under which the quotient is
    exact for every dividend below 2**63."""
    m, l = _divisor_constants(d)
    assert m < 2 ** 64
    assert (1 << (63 + l)) <= m * d <= (1 << (63 + l)) + (1 << l)
    assert _cuda.divisor_constants(d) == (m - 2 ** 64 if m >= 2 ** 63
                                          else m, l)
    rng = np.random.default_rng(d)
    edges = [0, 1, d - 1, d, d + 1, 2 ** 44 - 1, 2 ** 44, 2 ** 44 + 1,
             2 ** 62, 2 ** 63 - 1]
    b = np.concatenate([
        np.array(edges, dtype=np.int64),
        rng.integers(0, 2 ** 63 - 1, 4000, dtype=np.int64, endpoint=True),
        rng.integers(0, 2 ** 49, 4000, dtype=np.int64),
        rng.integers(0, 64 * d, 2000, dtype=np.int64),
        # Either side of multiples of d, where a quotient off by one shows.
        (rng.integers(1, (2 ** 63 - 2) // d, 2000, dtype=np.int64) * d
         + rng.integers(-1, 2, 2000, dtype=np.int64))])
    r = np.full(len(b), -1, dtype=np.int64)
    host_lib.ws_host_mod(b.ctypes.data, len(b), d, m, l, r.ctypes.data)
    assert r.tolist() == [int(x) % d for x in b]


def test_marshal_divisor_columns_match_independent_constants():
    """Every unit's multiply-high columns, across the paper suite and the
    odd and 16-SM geometries, equal the test's own constants for its
    nctrl and n_sets."""
    cfgs = (list(rmachines.paper_suite().values()) + _smoke_odd_suite()
            + _sixteen_sm_suite() + _wide_way_suite())
    _ref, port = _family_pairs(get_workload("BFS", n_threads=64), cfgs)
    fam = _cuda.marshal([(_cuda.stream_cols(s), c) for s, c in port],
                        device="cpu")
    for row, (_s, cfg) in zip(fam.up.tolist(), port):
        p = dict(zip(_cuda.UP_COLS, row))
        assert (p["nctrl"], p["n_sets"]) == (cfg.num_mem_ctrls, cfg.l1_sets)
        for d, col in ((p["nctrl"], "ctrl"), (p["n_sets"], "sets")):
            m, l = _divisor_constants(d)
            assert (p[f"{col}_mul"] % 2 ** 64, p[f"{col}_shift"]) == (m, l)


def test_cuda_source_host_build_matches_native(host_lib):
    families = [(get_workload(b, n_threads=N_THREADS),
                 list(rmachines.paper_suite().values()))
                for b in GOLDEN_BENCHES]
    families.append((get_workload("MTM", n_threads=256), _odd_suite()))
    for wl, cfgs in families:
        _check_host_build(host_lib, wl, cfgs)


@pytest.mark.parametrize("bench", BENCHMARKS)
def test_host_build_matches_native_on_paper_grid_seed0(host_lib, bench):
    """The main path's seed-0 family at the default sizes."""
    _check_host_build(host_lib, get_workload(bench, seed=0),
                      list(rmachines.paper_suite().values()))


@pytest.mark.parametrize("suite", [_smoke_odd_suite, _sixteen_sm_suite,
                                   _wide_way_suite],
                         ids=["odd", "16sm", "wide_ways"])
@pytest.mark.parametrize("bench", ["BFS", "MTM", "NW"])
def test_host_build_matches_native_on_other_geometries(host_lib, bench,
                                                       suite):
    _check_host_build(host_lib, get_workload(bench, n_threads=256), suite())


@pytest.mark.parametrize("sweep", ["dense", "simd32"])
@pytest.mark.parametrize("bench", BENCHMARKS)
def test_host_build_matches_native_on_sweep_families(host_lib, bench, sweep):
    """The seed-0 families of the dense sweep (ws4 at 2,048 threads: 512
    warps a unit) and of Fig. 1's simd32 sweep (warps of up to 256
    threads) at the default sizes."""
    cfgs = ([rmachines.baseline(w) for w in (4, 8, 16, 32, 64, 128)]
            if sweep == "dense"
            else list(rmachines.warp_size_sweep(32).values()))
    _check_host_build(host_lib, get_workload(bench, seed=0), cfgs)


def _v100_suite():
    """The ``v100`` benchmark configuration's machines
    (``warpbench/configs/v100.json``): 80 SMs of 2,048 threads, 8
    controllers at 900 GB/s, 128 KB of L1, the paper's six machines at
    SIMD 16."""
    kw = dict(num_sms=80, threads_per_sm=2048, num_mem_ctrls=8,
              dram_bw_gbps=180.0, core_clock_ghz=1.53, l1_size_bytes=131072)
    return ([rmachines.baseline(w, 16, **kw) for w in (16, 32, 64, 128)]
            + [rmachines.sw_plus(16, **kw), rmachines.lw_plus(16, **kw)])


@pytest.mark.parametrize("n_threads,rounds", [(4224, 1), (8448, 1)])
def test_host_build_matches_native_on_v100_units_over_256_warps(
        host_lib, n_threads, rounds):
    """K2's rescan path, where a lane's registers no longer hold its warps'
    ready times: V100-shaped families whose widest units (ws16, SW+) have
    264 warps (just over 256, not a multiple of it) and 528, in both
    placements, bit for bit with the C core; and the records equal those
    of the benchmark's plain reference (``warpbench.reference``)."""
    from warpbench import reference as wref
    wl = get_workload("BFS", n_threads=n_threads, seed=0)
    fam = _check_host_build(host_lib, wl, _v100_suite())
    widest = max(fam.up[:, _cuda.UP_COLS.index("n_warps")].tolist())
    assert widest == n_threads // 16
    assert _cuda.scan_rounds(widest) == rounds
    ref, port = _family_pairs(wl, _v100_suite())
    got = [dataclasses.asdict(ttiming.loop_result(
        wl.name, cfg, loop, ttiming.stream_totals(stream)))
        for (stream, cfg), loop in zip(port, _native_loops(ref))]
    assert got == wref.records([(wl.name, n_threads, 0, dataclasses.asdict(
        cfg)) for _stream, cfg in port])


def _two_sm_suite():
    """2-SM machines, whose state fits shared memory: at 16,384 threads
    units of 2,048 (ws8) and 1,024 (ws16) warps beside LW+'s 256."""
    return [rmachines.baseline(8, num_sms=2),
            rmachines.baseline(16, num_sms=2), rmachines.lw_plus(num_sms=2)]


@pytest.mark.parametrize("suite,n_threads,wide", [
    (_two_sm_suite, 16384, [1024, 2048]),
    (_v100_suite, 163840, [1280, 2560, 5120, 10240])], ids=["2sm", "v100"])
def test_host_build_matches_native_on_bands(host_lib, suite, n_threads,
                                            wide):
    """K2's bands above 256 warps, in both placements, bit for bit with
    the C core: 2-SM units of 1,024 and 2,048 warps (each lane keeps its
    part of every band), and the ``v100`` family at 163,840 threads,
    whose ws16 and SW+ units have 10,240 warps (40 whole bands, in the
    lanes' registers 0 and 1)."""
    fam = _check_host_build(
        host_lib, get_workload("BFS", n_threads=n_threads, seed=0), suite())
    widths = fam.up[:, _cuda.UP_COLS.index("n_warps")].tolist()
    assert sorted({n for n in widths if n > _cuda.REGISTER_WARPS}) == wide


def test_host_build_matches_native_on_66000_warps(host_lib):
    """Bands of 512 warps, read in two rounds: one synthetic stream of
    66,000 warps on a 4-SM machine and its SW+ twin, in both placements,
    bit for bit with the C core."""
    from test_torch_k2_scan_rounds import wide_cols
    cols = wide_cols(66000)
    cfgs = [rmachines.baseline(4, 4, num_sms=4),
            rmachines.sw_plus(4, num_sms=4)]
    want = [_native.run_scheduling_loop(*cols, cfg) for cfg in cfgs]
    fam = _cuda.marshal([(cols, _port_cfg(c)) for c in cfgs], device="cpu")
    for placement in _cuda.PLACEMENTS:
        cycles, counts = _host_family(host_lib, fam, placement)
        loops = [(c, o, m, h) for c, (o, m, h) in zip(cycles.tolist(),
                                                      counts.tolist())]
        assert loops == want, placement


def _first_min_pops(ready, after):
    """What the pops must give: heapq's (time, warp) order, by a plain
    scan for the first minimum (numpy's argmin)."""
    ready = np.array(ready, dtype=np.float64)
    order = []
    for t_next in after:
        w = int(np.argmin(ready))
        if not ready[w] < float("inf"):
            order.append(-1)
            break
        order.append(w)
        ready[w] = t_next
    return order


@pytest.mark.parametrize("case", ["ties", "inf", "one_lane", "many_warps"])
def test_host_pop_keeps_first_minimum_on_ties(host_lib, case):
    inf = float("inf")
    rng = np.random.default_rng(3)
    if case == "ties":       # equal times across lanes and within a lane
        ready = [5.0] * 70 + [4.0, 5.0, 4.0]
        after = [4.0, 5.0, 4.0] * 30 + [3.0] * 10
    elif case == "inf":      # finished warps, then every warp inf
        ready = [inf, 2.0, inf, 2.0, inf] * 9
        after = [inf] * 19 + [2.0] + [inf] * 30
    elif case == "one_lane":  # every ready warp in lane 0
        ready = [1.0 if j % 32 == 0 else inf for j in range(256)]
        after = [1.0, 1.0, 0.5] * 20
    else:
        ready = list(rng.integers(0, 6, 256).astype(np.float64))
        after = list(rng.integers(0, 8, 2000).astype(np.float64))
        after[::7] = [inf] * len(after[::7])
    assert _host_pops(host_lib, ready, after) == _first_min_pops(ready,
                                                                 after)


def _host_pops(lib, ready, after):
    r = np.array(ready, dtype=np.float64)
    a = np.array(after, dtype=np.float64)
    order = np.full(len(after), -9, dtype=np.int64)
    n = lib.ws_host_pops(r.ctypes.data, len(r), a.ctypes.data, len(a),
                         order.ctypes.data)
    return order[:n].tolist()


@pytest.mark.parametrize("case", ["in_band", "across_bands", "inf"])
@pytest.mark.parametrize("nw", [257, 264, 512, 513, 528, 2048, 10240,
                                65537])
def test_host_pop_keeps_first_minimum_on_ties_in_bands(host_lib, nw, case):
    """Units above 256 warps, whose lanes keep first minima of bands (each
    lane its part of every band up to 2,048 warps): ties between warps of
    one band, between bands (those of one lane, 32 bands apart, among
    them), and warps that finish (inf) until every warp is inf; 65,537
    warps make bands of 512 warps, read in two rounds."""
    inf = float("inf")
    rng = np.random.default_rng(nw)
    span = 256 * -(-nw // 65536)
    n_pops = 3000
    if case == "in_band":    # few distinct times: ties everywhere
        ready = rng.integers(0, 3, nw).astype(np.float64)
        after = rng.integers(0, 4, n_pops).astype(np.float64)
    elif case == "across_bands":   # one time, the same offset in each band
        ready = np.full(nw, 9.0)
        for b in range(-(-nw // span)):
            for x in (5, 37, span - 1):
                if b * span + x < nw:
                    ready[b * span + x] = 2.0
        after = np.tile([2.0, 3.0, 2.0, 9.0], n_pops // 4)
    else:   # warps finish, a few come back, then every warp finishes
        ready = np.where(rng.random(nw) < 0.9, inf, rng.integers(0, 5, nw))
        after = np.full(n_pops + int(np.isfinite(ready).sum()), inf)
        after[:n_pops:50] = 1.0
    want = _first_min_pops(ready, after)
    if case == "inf":
        assert want[-1] == -1
    assert _host_pops(host_lib, ready, after) == want


@pytest.mark.parametrize("ways", [1, 3, 8, 32, 33, 40, 72])
def test_host_find_way_and_victim_on_crafted_sets(host_lib, ways):
    rng = np.random.default_rng(ways)

    def find(tags, s, fills=None, t=0.0):
        """(way, first empty way, whether the way's fill is <= t)."""
        tags = np.ascontiguousarray(tags, dtype=np.int32)
        fills = np.ascontiguousarray(
            np.zeros(ways) if fills is None else fills, dtype=np.float64)
        empty = np.zeros(1, dtype=np.int32)
        fresh = np.zeros(1, dtype=np.bool_)
        way = host_lib.ws_host_find_way(tags.ctypes.data, fills.ctypes.data,
                                        ways, s, t, empty.ctypes.data,
                                        fresh.ctypes.data)
        return way, int(empty[0]), bool(fresh[0])

    def victim(ticks):
        ticks = np.ascontiguousarray(ticks, dtype=np.int32)
        return host_lib.ws_host_victim(ticks.ctypes.data, ways)

    def first(xs, x):
        return next((i for i, v in enumerate(xs) if v == x), -1)

    # A slot held twice: the first way wins; empty ways before and after.
    tags = rng.permutation(np.arange(100, 100 + ways))
    tags[ways // 2] = tags[-1] = 7
    tags[ways // 3] = -1
    way, empty, _ = find(tags, 7)
    assert way == first(list(tags), 7)
    # The hit way's fill time against t, equal times included; the other
    # copy of the slot does not count.
    if way >= 0:
        fills = np.full(ways, 50.0)
        fills[way] = 40.0
        assert find(tags, 7, fills, 40.0)[2]
        assert not find(tags, 7, fills, 39.5)[2]
    if 0 <= way < ways - 1:
        fills[way], fills[-1] = 60.0, 0.0
        assert not find(tags, 7, fills, 40.0)[2]
    # A miss reports the first empty way, or -1 in a full set.
    way, empty, fresh = find(tags, 5)
    assert way == -1 and empty == first(list(tags), -1) and not fresh
    full = np.arange(200, 200 + ways)
    assert find(full, 5) == (-1, -1, False)
    # Equal ticks: the lowest way among the least.
    ticks = rng.integers(10, 20, ways)
    for lo in sorted({ways - 1, ways // 2, min(33, ways - 1)}, reverse=True):
        ticks[lo] = 3
    assert victim(ticks) == first(list(ticks), 3)
    assert victim(np.full(ways, 9)) == 0
    ticks = np.arange(ways, 0, -1)
    assert victim(ticks) == ways - 1


def test_placement_is_global_where_state_overflows_shared_memory():
    """MTM's SW+ unit (a 17,152-slot outstanding table) and the 16-SM SW+
    machine do not fit one block's shared memory; the rest of the paper
    grid does."""
    suite = rmachines.paper_suite()

    def fam(bench, cfgs):
        _ref, port = _family_pairs(get_workload(bench, seed=0), cfgs)
        return _cuda.marshal([(_cuda.stream_cols(s), c) for s, c in port],
                             device="cpu")

    mtm = fam("MTM", list(suite.values()))
    assert mtm.state_bytes > _cuda.SMEM_LIMIT
    assert _cuda.placement(mtm) == "global"
    no_sw = fam("MTM", [c for name, c in suite.items() if name != "SW+"])
    assert _cuda.placement(no_sw) == "shared"
    assert _cuda.placement(fam("GAS", list(suite.values()))) == "shared"
    assert _cuda.placement(fam("BFS", _sixteen_sm_suite())) == "global"
    # The sizes are the layout's: the small part padded to even, the big
    # one after it.
    one = fam("BFS", [suite["ws8"]])
    p = dict(zip(_cuda.UP_COLS, one.up[0].tolist()))
    lines = p["n_sms"] * p["n_sets"] * p["ways"]
    small = 5 * p["n_warps"] + p["n_sms"] + p["nctrl"] + -(-p["n_sms"] // 2)
    small += small % 2
    assert p["big_off"] - p["small_off"] == small
    assert one.state_bytes == 8 * (small + 2 * lines)


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
    for got, want in zip(_cuda.prep(fam), _cuda.prep_ref(
            fam.up, fam.fp, fam.blocks, fam.nbytes)):
        assert torch.equal(got, want)
    cycles, counts = _cuda.simulate_family(fam)
    torch.cuda.synchronize()
    cpu = _cuda.marshal(units, device="cpu")
    want_c, want_n = _cuda.simulate_family(cpu)
    assert torch.equal(cycles.cpu(), want_c)
    assert torch.equal(counts.cpu(), want_n)
    assert {k: _cuda.launch_count(k) - before[k] for k in _cuda.KERNELS} \
        == {k: 1 for k in _cuda.KERNELS}


@pytest.mark.gpu
@pytest.mark.parametrize("placement", _cuda.PLACEMENTS)
def test_k2_placements_match_plain_versions_on_card(card, placement):
    """Each placement of K2's state, bit for bit against the plain version,
    on the paper suite beside L1s of more than 32 ways (which fits shared
    memory whole) and the 16-SM machine (which does not): once as the
    wrapper picks it, once named."""
    _ref, port = _family_pairs(get_workload("MTM", n_threads=256),
                               list(rmachines.paper_suite().values())
                               + _wide_way_suite())
    _ref16, port16 = _family_pairs(get_workload("BFS", n_threads=256),
                                   _sixteen_sm_suite())
    for pairs in (port, port16):
        units = [(_cuda.stream_cols(s), c) for s, c in pairs]
        fam = _cuda.marshal(units, device=card)
        if placement == "shared" and fam.state_bytes > _cuda.SMEM_LIMIT:
            continue
        cpu = _cuda.marshal(units, device="cpu")
        want_c, want_n = _cuda.simulate_family(cpu)
        picked = _cuda.placement(fam)
        for where in {picked, placement}:
            before = _cuda.route_count("ws_family_kernel", where)
            cycles, counts = _cuda.simulate_family(fam, where=where)
            torch.cuda.synchronize()
            assert _cuda.route_count("ws_family_kernel", where) == before + 1
            assert torch.equal(cycles.cpu(), want_c), (where, picked)
            assert torch.equal(counts.cpu(), want_n), (where, picked)


@pytest.mark.gpu
def test_study_on_card_matches_cpu(card):
    study = tapi.Study(benches=GOLDEN_BENCHES, n_threads=N_THREADS)
    got = tapi.Session(device=card).run(dataclasses.replace(study,
                                                            engine="cuda"))
    want = tapi.Session(device="cpu").run(study)
    assert got.stats["family_launches"] == 5
    assert [dataclasses.asdict(r) for r in got.records] == [
        dataclasses.asdict(r) for r in want.records]


@pytest.mark.gpu
def test_paper_study_on_card_launches_one_kernel_a_family(card):
    """The paper grid (seeds 0-2, 45 trace families) on the card: one K2
    launch a family and no K1 launch, with every record equal to the
    reference grid file."""
    _cuda.reset_launch_counts()
    got = tapi.Session(device=card).run(tapi.Study(seeds=(0, 1, 2),
                                                   engine="cuda"))
    torch.cuda.synchronize()
    assert got.stats["family_launches"] == 45
    assert {k: _cuda.launch_count(k) for k in _cuda.KERNELS} == {
        "ws_prep_kernel": 0, "ws_family_kernel": 45}
    with open(GRID_FILE, encoding="utf-8") as fh:
        want = json.load(fh)["records"]
    assert [{"machine": r.machine, "bench": r.bench, "seed": r.seed,
             "n_threads": r.n_threads, "result": _encode_result(r.result)}
            for r in got.records] == want


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-grid"]:
        write_grid_file()
        print(f"wrote {GRID_FILE}")
    else:
        sys.exit("usage: python tests/test_torch_warpsim.py --write-grid")
