"""The harness finds cells, configurations, drivers and metrics by name,
and reads a traced window's numbers; all on the CPU."""
import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from chipbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_benchmark_json_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["chipbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names), names
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_entry_has_its_files(bench, kind):
    for entry in bench[kind]:
        if kind == "configs":
            cfg = harness.load_json(harness.ROOT / entry["file"])
            assert cfg["name"] == entry["name"]
            assert cfg["source"] == entry["source"]
            assert cfg["reduced"] == entry["reduced"]
            continue
        e, cfg, wl = harness.find_cell(bench, entry["name"])
        assert cfg["name"] == entry["config"] and e is entry
        assert (harness.HERE / "drivers" / f"{wl['driver']}.py").is_file()
        assert entry["chips"] == 1


def test_every_cell_reports_setup_an_e2e_and_a_layer_metric(bench):
    readers = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.metrics_for(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_for(bench, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in e2e and m["name"] in readers


def test_metrics_for_selects_by_list_or_by_moves():
    """End-to-end metrics by their list, every cell where there is none;
    per-layer metrics by their list, which each has to have."""
    bench = {"end_to_end": [{"name": "a", "workloads": ["x"]},
                            {"name": "setup_s"}],
             "per_layer": [{"name": "l1", "moves": "a", "workloads": ["x"]},
                           {"name": "l2", "moves": "a", "workloads": ["y"]},
                           {"name": "l3", "moves": "setup_s",
                            "workloads": ["x", "y"]}]}
    assert [m["name"] for m in harness.metrics_for(bench, "x", False)] == \
        ["a", "setup_s"]
    assert [m["name"] for m in harness.metrics_for(bench, "y", False)] == \
        ["setup_s"]
    assert [m["name"] for m in harness.metrics_for(bench, "x", True)] == \
        ["l1", "l3"]
    assert [m["name"] for m in harness.metrics_for(bench, "y", True)] == \
        ["l2", "l3"]
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(KeyError):
        harness.metrics_for(bench, "x", True)


def _dummy_root(tmp_path):
    """A benchmark tree of one new cell, one new configuration and one
    new metric, added as files only."""
    for sub in ("configs", "workloads", "drivers", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "source": "https://example.org/toy", "reduced": []}))
    (tmp_path / "workloads" / "toy.sleep.json").write_text(json.dumps(
        {"driver": "sleeper", "traffic": {"nap_s": 0.002},
         "limits": {"gap": 0.5}}))
    (tmp_path / "drivers" / "sleeper.py").write_text(
        "import time\n"
        "from torch.profiler import record_function\n"
        "from chipbench import harness\n"
        "def run(cell):\n"
        "    win = harness.Window(cell)\n"
        "    win.start()\n"
        "    while True:\n"
        "        with record_function('bench.call'):\n"
        "            time.sleep(cell.traffic['nap_s'])\n"
        "        if not win.tick():\n"
        "            break\n"
        "    win.stop()\n"
        "    return harness.Outcome(attempted=win.iters, failed=0,\n"
        "        e2e={'naps_per_s': win.iters / win.seconds,\n"
        "             'setup_s': win.t0 - cell.t_start},\n"
        "        checks=[('gap', 0.0, cell.limits['gap'])],\n"
        "        memory_peak_bytes=0, window=win)\n")
    (tmp_path / "metrics" / "nap_ms.toy.py").write_text(
        "from statistics import mean\n"
        "def read(trace):\n"
        "    return mean(trace.span_durations('bench.call')) * 1e3\n")
    return {"end_to_end": [{"name": "naps_per_s", "unit": "1/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "nap_ms.toy", "unit": "ms",
                           "moves": "naps_per_s",
                           "workloads": ["toy.sleep"]}],
            "workloads": [{"name": "toy.sleep", "config": "toy",
                           "traffic": "sleep", "chips": 1}]}


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path, trace):
    bench = _dummy_root(tmp_path)
    entry, cfg, wl = harness.find_cell(bench, "toy.sleep", root=tmp_path)
    cell = harness.Cell(name="toy.sleep", entry=entry, config=cfg,
                        workload=wl, seed=1, seconds=0.05, trace=trace,
                        device="cpu", t_start=time.perf_counter())
    r = harness.run_cell(bench, cell, root=tmp_path)
    assert r["correct"] and r["attempted"] >= 1
    want = {"nap_ms.toy"} if trace else {"naps_per_s", "setup_s"}
    assert set(r["metrics"]) == want
    if trace:
        assert r["metrics"]["nap_ms.toy"]["value"] >= 2.0
        assert r["breakdown"]["device_ops"] == []
    assert list(r)[-1] == "checks"
    assert r["checks"] == {"gap": {"value": 0.0, "limit": 0.5}}


def test_short_names():
    assert harness.short_name(
        "void (anonymous namespace)::unmask_kernel<1>(unsigned int const*, "
        "float*, long, long, unsigned int, float)") == "unmask_kernel"
    assert harness.short_name(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
        "at::native::FillFunctor<float>, std::array<char*, 1ul>)") == \
        "vectorized_elementwise_kernel"
    assert harness.short_name("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT") \
        == "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT"


def _trace():
    ops = [("unmask_kernel", "kernel", 1.0, 0.5),
           ("gather", "kernel", 1.4, 0.3),       # overlaps the first
           ("vote_kernel", "kernel", 2.0, 0.5),
           ("Memcpy DtoD", "memcpy", 3.0, 0.25)]
    spans = [("bench.call", 0.9, 1.1), ("bench.call", 1.9, 2.1),
             ("bench.call", 2.4, 3.5), ("inner", 2.45, 2.8)]
    return harness.Trace(ops=ops, spans=spans, window_s=2.6, iters=3)


def test_trace_busy_idle_and_breakdown():
    tr = _trace()
    assert tr.bounds() == (0.9, 3.5)
    assert tr.busy_s() == pytest.approx(0.7 + 0.5 + 0.25)
    assert tr.op_time(lambda n: n.endswith("kernel")) == (1.0, 2)
    # each gap goes to the innermost span open at its start: 0.9-1.0 and
    # 3.25-3.5 in a call, 1.7-2.0 in none, 2.5-3.0 in "inner"
    assert dict(tr.idle_gaps()) == pytest.approx(
        {"bench.call": 0.35, "(no span)": 0.3, "inner": 0.5})
    assert tr.device_ops()[0] == ["unmask_kernel", 0.5]
    tr.spans = [s for s in tr.spans if s[0] == "inner"]
    with pytest.raises(ValueError):
        tr.bounds()


def test_percentile_is_over_all_values():
    vals = list(range(1, 101))
    assert harness.percentile(vals, 95) == pytest.approx(95.05)
    assert harness.percentile([3.0], 95) == 3.0


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.loaded_forbidden({"repro_torch": 0, "repro_torch.api": 0,
                                     "jaxtyping": 0, "torch": 0}) == []
    assert harness.loaded_forbidden({"jax.numpy": 0, "repro.api": 0,
                                     "flax": 0}) == ["flax", "jax", "repro"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    """A checkout without the program, and a machine without the card:
    both fail before any result line."""
    for sub in ("chipbench",):
        shutil.copytree(harness.HERE, tmp_path / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    procs = [subprocess.Popen(
        [sys.executable, "chipbench/run.py", "--workload",
         "secagg-n64.allreduce-full", "--seed", "2147483999",
         "--seconds", "1", "--trace", "0"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for root in (harness.ROOT, tmp_path)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode != 0
        assert out.strip() == ""
