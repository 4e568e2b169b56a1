"""The host-stage timers' arithmetic, K2's work counts, and the reading
of a device trace."""

import types

import pytest

from warpbench import devtrace, k2work, reference, stages


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def fake(monkeypatch):
    """A sweep and a _cuda module whose calls each take a known time."""
    clock = Clock()
    monkeypatch.setattr(stages.time, "perf_counter", clock)

    def cost(seconds, inner=None):
        def fn(*args, **kw):
            clock.t += seconds
            if inner is not None:
                inner()
            return seconds
        return fn
    sweep = types.SimpleNamespace(build_thread_trace=cost(1.0),
                                  aggregate_stream=cost(2.0))
    cuda = types.SimpleNamespace(marshal=cost(3.0), collect=cost(5.0))
    # The launch marshals through the module, as _cuda.launch_family does.
    cuda.launch_family = cost(4.0, inner=lambda: cuda.marshal())
    return sweep, cuda


def test_stage_timers_sum_each_stage_and_take_marshal_out_of_launch(fake):
    sweep, cuda = fake
    originals = (sweep.build_thread_trace, cuda.launch_family, cuda.collect)
    with stages.stage_timers(sweep, cuda) as secs:
        for _ in range(2):
            sweep.build_thread_trace()
            sweep.aggregate_stream()
            cuda.launch_family()
            cuda.collect()
    assert secs == {"trace": 2.0, "aggregate": 4.0, "marshal": 6.0,
                    "launch": 8.0, "wait": 10.0}
    assert (sweep.build_thread_trace, cuda.launch_family,
            cuda.collect) == originals
    assert stages.per_cell_us(secs, ("marshal", "launch"), 7) == \
        pytest.approx(1e6 * 14.0 / 7)
    assert stages.per_cell_us(secs, ("wait",), 0) is None


def test_stage_timers_restore_after_an_error(fake):
    sweep, cuda = fake
    saved = cuda.collect
    with pytest.raises(RuntimeError):
        with stages.stage_timers(sweep, cuda):
            raise RuntimeError("boom")
    assert cuda.collect is saved


def _stream(n_ops, n_blocks, n_warps):
    return types.SimpleNamespace(issue=[0] * n_ops, blocks=[0] * n_blocks,
                                 n_warps=n_warps)


def test_launch_work_counts_the_longest_unit_and_every_units_bytes():
    calls = []
    cuda = types.SimpleNamespace(launch_family=lambda pairs, *a: calls.append(
        len(pairs)))
    with stages.launch_work(cuda) as work:
        cuda.launch_family([(_stream(10, 4, 2), None),
                            (_stream(3, 1, 1), None)], "cpu", "torch")
    assert calls == [2]
    assert work == [(10, (25 * 10 + 16 * 4 + 16 * 2 + 32)
                     + (25 * 3 + 16 * 1 + 16 * 1 + 32))]


def test_k2_work_on_a_tiny_two_sm_grid_against_hand_counts():
    """BKP on 16 threads: six passes of two loads, a compute run, a
    strided load, a compute run and a store. ws8 has two warps of 36 ops;
    each pass touches one 64 B block per warp in each of its 4 memory
    ops (8 threads x 4 B, the 1 KB table, 8 threads x 8 B, the store).
    ws16 has one warp of 36 ops, and its strided load spans 128 B: two
    blocks, so 5 a pass."""
    from repro_torch.core.warpsim import _cuda, api
    from repro_torch.core.warpsim.config import MachineConfig
    ws8 = MachineConfig(name="ws8", warp_size=8, num_sms=2)
    ws16 = MachineConfig(name="ws16", warp_size=16, num_sms=2)
    hand8 = (72, 25 * 72 + 16 * 48 + 16 * 2 + 32)
    hand16 = (36, 25 * 36 + 16 * 30 + 16 * 1 + 32)
    assert k2work.unit(72, 48, 2) == hand8
    with stages.launch_work(_cuda) as work:
        api.Session(device="cpu").run(api.Study(
            benches=("BKP",), machines={"ws8": ws8, "ws16": ws16},
            n_threads=16, seeds=(3,), engine="torch"))
    assert work == [(72, hand8[1] + hand16[1])]
    # The reference's own expansion gives the same counts.
    s8 = reference.expand("BKP", 16, 3, 8, 8, False, 64)
    assert (len(s8["issue"]), len(s8["blocks"]), s8["n_warps"]) == (72, 48, 2)


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_device_trace_summary_unions_device_time_and_names_the_gaps():
    trace = {"traceEvents": [
        _event("user_annotation", devtrace.WINDOW, 0.0, 100.0),
        _event("user_annotation", "aggregate", 0.0, 20.0),
        _event("user_annotation", "wait", 60.0, 40.0),
        _event("kernel", "void ws_family_kernel<false>(long)", 20.0, 30.0),
        _event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 40.0, 20.0),
        _event("kernel", "void ws_family_kernel<true>(long)", 70.0, 10.0),
        _event("cpu_op", "aten::empty", 5.0, 90.0),
    ]}
    s = devtrace.summarize(trace)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(50e-6)           # 20..60 and 70..80
    assert s["k2_s"] == pytest.approx(40e-6) and s["k2_records"] == 2
    assert s["gaps"] == [("aggregate", pytest.approx(20e-6)),
                         ("wait", pytest.approx(20e-6)),
                         ("wait", pytest.approx(10e-6))]
    b = devtrace.breakdown(s, n=2)
    assert b["device_ops"][0] == ["void_ws_family_kernel_false__long_",
                                  pytest.approx(30e-6)]
    assert len(b["device_ops"]) == 2 and len(b["idle_gaps"]) == 2
