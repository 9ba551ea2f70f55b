"""Whole runs of the harness on the CPU at the smoke configurations (the
look for a card skipped): the result line, tails over all requests and
rates over the window, and the check coming out false under each fault
the cells can have and under the control (the reference in fp8)."""
import json
import time

import pytest

from portbench import faults as F
from portbench import harness
from portbench.tests.conftest import DATA

SEED = 2 ** 33 + 5


def _run(bench, name, fault=None, control=False, trace=False,
         seconds=1.5):
    cell = harness.load_cell(name, bench, base=DATA)
    loop = harness.loop_module(cell.spec["loop"])
    return cell, loop.run(cell, SEED, seconds, trace, "cpu",
                          time.perf_counter(), fault=fault, control=control)


def _line(cell, res, trace, capsys):
    from portbench.run import emit
    assert emit(cell, res, trace, "cpu") == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    return line, out.err.strip().splitlines()


@pytest.mark.parametrize("name", ["smoke-train", "smoke-batch",
                                  "smoke-rate"])
def test_sound_run_is_correct(smoke_bench, name, capsys):
    cell, res = _run(smoke_bench, name, trace=True)
    assert res["correct"], res["checks"]
    line, err = _line(cell, res, True, capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert err[-len(res["checks"]):] == [
        f"check {k}: {v['value']!r} limit {v['limit']!r}"
        for k, v in res["checks"].items()]
    res["record"] = None
    line, _ = _line(cell, res, False, capsys)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("fault", [F.unchanged, F.half_batch,
                                   F.flip_update])
def test_training_faults_are_caught(smoke_bench, fault):
    _, res = _run(smoke_bench, "smoke-train", fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["smoke-batch", "smoke-rate"])
def test_an_altered_token_is_caught(smoke_bench, name):
    _, res = _run(smoke_bench, name, fault=F.token)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["smoke-train", "smoke-batch"])
def test_the_control_fails_the_limits(smoke_bench, name):
    """The reference in fp8 put in the program's place reads past the
    limits that the program's fp32 runs meet here."""
    cell, res = _run(smoke_bench, name, control=True)
    assert res["correct"]
    limits = cell.spec["limits"]
    assert any(res["control"][k] > lim for k, lim in limits.items())
    assert res["control"]["correct"] is False


def test_tails_are_over_every_request(smoke_bench):
    cell, res = _run(smoke_bench, "smoke-rate", seconds=2.0)
    assert res["attempted"] >= 10 and res["failed"] == 0
    e2e = res["end_to_end"]
    assert e2e["ttft_p50_ms"] > 0 and e2e["itl_p95_ms"] > 0
