"""BENCHMARK.json against the contract it is written to, and the harness
finding a cell, a traffic mix and a metric by their names."""
import json
import re
import shutil

import pytest

from portbench import harness
from portbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level(bench):
    assert set(bench) == KEYS
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (REPO / bench["command"][1]).is_file()
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_fields(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (REPO / c["file"]).is_file()
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and conf["source"] == \
            c["source"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_is_whole(bench):
    chips4 = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(chips4) <= 1
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], bench)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported and m["moves"] in e2e
            harness.reader(m["name"])          # the reader exists
        harness.loop_module(cell.spec["loop"])
        assert set(cell.spec["limits"])


def test_new_cell_and_metric_are_added_files(tmp_path, bench):
    """A cell, its traffic and a per-layer metric that exist only as new
    files and a new manifest entry are found and read."""
    base = tmp_path / "bench"
    for sub in ("workloads", "traffic", "metrics"):
        (base / sub).mkdir(parents=True)
    src = harness.HERE
    shutil.copy(src / "workloads" / "jamba-serve-batch.json",
                base / "workloads" / "jamba-serve-long.json")
    (base / "traffic" / "long-batch.json").write_text(json.dumps(
        {"prompt": {"dist": "log_uniform", "lo": 2048, "hi": 3584},
         "output": {"dist": "uniform", "lo": 16, "hi": 64},
         "queue_depth": 64}))
    (base / "metrics" / "prefill_share.serve.py").write_text(
        "def read(rec):\n"
        "    c = rec['counters']\n"
        "    return 100.0 * c['prefill_s'] / (c['prefill_s'] + "
        "c['decode_s'])\n")
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "jamba-serve-long",
                             "config": "jamba-v0.1-52b-p1",
                             "traffic": "long-batch", "chips": 1,
                             "why": "long prompts"})
    new["per_layer"].append({"name": "prefill_share.serve", "unit": "%",
                             "better": "lower", "source": "program_span",
                             "layer": "engine",
                             "moves": "output_tokens_per_s",
                             "workloads": ["jamba-serve-long"]})
    cell = harness.load_cell("jamba-serve-long", new, base=base)
    assert cell.traffic["prompt"]["lo"] == 2048
    assert [m["name"] for m in cell.per_layer] == ["prefill_share.serve"]
    got = harness.per_layer_values(
        cell, {"counters": {"prefill_s": 1.0, "decode_s": 3.0}}, base=base)
    assert got == {"prefill_share.serve": {"value": 25.0, "unit": "%"}}


def test_metric_without_workloads_goes_to_every_reporting_cell(bench):
    new = json.loads(json.dumps(bench))
    new["per_layer"].append({"name": "idle_share.serve", "unit": "%",
                             "better": "lower", "source": "device_trace",
                             "layer": "device",
                             "moves": "output_tokens_per_s"})
    cell = harness.load_cell("jamba-serve-batch", new)
    assert [m["name"] for m in cell.per_layer].count("idle_share.serve") == 2
    other = harness.load_cell("jamba-serve-poisson", new)
    assert "idle_share.serve" not in [m["name"] for m in other.per_layer]


@pytest.mark.parametrize("missing", ["workloads", "traffic"])
def test_a_cell_without_its_files_is_refused(tmp_path, bench, missing):
    base = tmp_path / "b"
    for sub in ("workloads", "traffic"):
        (base / sub).mkdir(parents=True)
        if sub != missing:
            name = ("jamba-serve-batch" if sub == "workloads"
                    else "offline-batch")
            shutil.copy(harness.HERE / sub / f"{name}.json", base / sub)
    with pytest.raises(FileNotFoundError):
        harness.load_cell("jamba-serve-batch", bench, base=base)
