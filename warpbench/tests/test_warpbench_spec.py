"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
lookups by name."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from warpbench import run, spec

ROOT = str(spec.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "-m", "warpbench"]
    assert bench["paths"] == ["warpbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert all(_line(w) for w in bench["command"])


def test_names_and_units_use_only_the_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w["config"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in bench[group]]
        assert len(got) == len(set(got)), group
    assert len(json.dumps(bench)) < 64 * 1024


def test_entries_hold_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("warpbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["name"] for m in bench["end_to_end"]] == ["cells_per_s",
                                                        "setup_s"]
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] == "cells_per_s" and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        cells = {w["name"] for w in bench["workloads"]}
        assert set(m["workloads"]) <= cells


def test_each_cell_and_metric_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["loop"] == "closed"
        assert [m["name"] for m in cell.end_to_end] == ["cells_per_s",
                                                        "setup_s"]
        assert cell.per_layer, w["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    with pytest.raises(KeyError):
        spec.find_cell("paper-t1.nosuch", bench)


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path, bench):
    shutil.copytree(os.path.join(ROOT, "warpbench"),
                    tmp_path / "warpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "warpbench" / "traffic" / "rare.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "workload_seeds": "fresh",
         "per_step": {"dram_latency_cycles": [220, 620]}}))
    added = json.loads(json.dumps(bench))
    added["workloads"].append({"name": "paper-t1.rare", "config": "paper-t1",
                               "traffic": "rare", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added))
    cell = spec.find_cell("paper-t1.rare", root=tmp_path)
    assert cell.traffic["per_step"] == {"dram_latency_cycles": [220, 620]}
    # A metric that names no cells reports in every cell of its metric.
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in bench["per_layer"]
        if "paper-t1.rare" in m.get("workloads", ["paper-t1.rare"])}


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["repro.core.warpsim", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_imports_no_jax_and_no_reference_package():
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from warpbench.tests import tiny\n"
        "from warpbench import run, control\n"
        "r = run.run_cell(tiny.cell('paper-t1.cold'), 5, 0.1, True, 'cpu')\n"
        "assert r[1]['correct']\n"
        "print(run.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['.']\n"
            "import warpbench.reference, warpbench.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro', 'repro_torch', 'jax', 'torch'}))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_the_command_refuses_without_a_card_or_the_program(tmp_path):
    """Without a card, and in a directory that holds only BENCHMARK.json
    and the benchmark's files, a run exits non-zero and prints no
    result."""
    for where in (ROOT, tmp_path):
        if where == tmp_path:
            shutil.copytree(os.path.join(ROOT, "warpbench"),
                            tmp_path / "warpbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env.pop("PYTHONPATH", None)
        out = subprocess.run(
            [sys.executable, "-m", "warpbench", "--workload",
             "paper-t1.cold", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=str(where), env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
