"""``BENCHMARK.json`` against the benchmark's contract, every file it
names, and the shape of a run's last line."""
import io
import json
import re

import pytest

from perfbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _names():
    out = [c["name"] for c in BENCH["configs"]]
    out += [k for c in BENCH["configs"] for k in c["reduced"]]
    for w in BENCH["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    return out


@pytest.mark.parametrize("name", _names())
def test_name_characters(name):
    assert NAME.match(name), name


def test_top_level_and_entries():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (harness.ROOT / c["file"]).exists()
        config = json.loads((harness.ROOT / c["file"]).read_text())
        for key in ("driver", "reference"):
            assert (harness.BENCH / config[key]).is_file(), (c["name"], key)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert (harness.BENCH / "mixes" / f"{w['traffic']}.json").exists()
        assert (harness.BENCH / "limits" / f"{w['name']}.json").exists()
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] \
            + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    # four chips only in a quarter of the cells, rounded down, or in one
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        spec = harness.cell_spec(w["name"])
        e2e = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        # the limits name exactly the numbers in the driver module's CHECKS
        assert set(spec["limits"]) == set(harness.driver(spec).CHECKS)


def test_file_names_under_paths():
    for path in harness.BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_last_line_shape(tiny):
    """The last line on standard output: the keys the contract reads,
    ``checks`` last, each with its value and limit; the checks again as
    the last lines on standard error."""
    spec = tiny("fastchgnet.mptrj_b128")
    out, err = io.StringIO(), io.StringIO()
    for trace in (False, True):
        res = harness.run(spec, 2**31 + 9, 0.2, trace, device="cpu")
        harness.emit(res, out, err)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        assert list(line)[:5] == ["correct", "attempted", "failed",
                                  "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert isinstance(line["correct"], bool) and line["attempted"] > 0
        assert line["failed"] == 0
        names = {m["name"] for m in
                 spec["per_layer" if trace else "end_to_end"]}
        assert set(line["metrics"]) <= names
        for v in line["metrics"].values():
            assert set(v) == {"value", "unit"}
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
            line["device"])
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
        tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
        assert all(t.startswith("check ") for t in tail)
    # the end-to-end run reports every end-to-end metric of the cell
    first = json.loads(out.getvalue().strip().splitlines()[0])
    assert set(first["metrics"]) == {m["name"] for m in spec["end_to_end"]}
