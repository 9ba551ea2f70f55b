"""The port's examples (``src/repro_torch/examples/``) at tiny presets on
the CPU: quickstart's three transports against each other and against the
JAX package's ``moe_ffn`` on the same weights, its column splits against
JAX's ``choose_n_col``; the ablation's table against the JAX example's;
the continuous-batching and training drivers run to their end."""
import contextlib
import dataclasses
import io
import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import adaptive as JA
from repro.core.moe_layer import moe_ffn as jmoe_ffn
from repro.parallel.mesh import AxisCtx as JAxisCtx
from repro_torch.configs import get_config
from repro_torch.examples import (overlap_ablation, quickstart,
                                  serve_batched, train_moe)

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def test_quickstart_transports_match_jax():
    arch = "granite-moe-3b-a800m-smoke"
    res = quickstart.main(["--arch", arch, "--device", "cpu"])
    outs = {k: (y.numpy(), float(aux)) for k, (y, aux) in res["outs"].items()}
    params, x = quickstart.make_inputs(get_config(arch))
    jcfg = jax_config(arch)
    jp = {"router": jnp.asarray(params["router"]),
          "experts": {k: jnp.asarray(v)
                      for k, v in params["experts"].items()}}
    for impl, (y, aux) in outs.items():
        np.testing.assert_allclose(y, outs["naive"][0], rtol=1e-4, atol=1e-4)
        jy, jaux = jmoe_ffn(jcfg, dataclasses.replace(jcfg.moe, impl=impl),
                            jp, jnp.asarray(x), JAxisCtx())
        np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-4, atol=1e-4)
        assert aux == pytest.approx(float(jaux), rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("hw", ["tpu_v5e", "h100_nvlink"])
def test_quickstart_n_col_matches_jax(hw):
    for r in quickstart.n_col_table(hw):
        s = JA.MoEShape(M=r["M"], N=4096, K=14336, E=8, topk=2, ep=8, etp=1)
        assert r["n_col"] == JA.choose_n_col(JA.HW[hw], s)
        t = JA.layer_times(JA.HW[hw], s)
        assert r["t_hop"] == pytest.approx(t["t_hop"], rel=1e-12)


def test_quickstart_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])


@pytest.mark.parametrize("argv", [["--hw", "h100_nvlink"],
                                  ["--hw", "tpu_v5e", "--tpu"],
                                  ["--hw", "h100_nvlink", "--etp", "2"]])
def test_ablation_table_equals_jax_example(argv, monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["overlap_ablation.py", *argv])
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(EXAMPLES, "overlap_ablation.py"),
                       run_name="__main__")
    with contextlib.redirect_stdout(io.StringIO()):
        lines = overlap_ablation.main([*argv, "--device", "cpu"])
    assert lines == buf.getvalue().splitlines()


def test_serve_batched_reuses_slots():
    res = serve_batched.main(["--device", "cpu", "--requests", "3",
                              "--slots", "2", "--max-new", "4",
                              "--max-seq", "32"])
    assert res["admissions"] == 3
    assert sorted(res["streams"]) == [0, 1, 2]
    assert all(len(s) == 4 for s in res["streams"].values())


def test_train_moe_accumulates_and_checkpoints(tmp_path):
    res = train_moe.main(["--preset", "tiny", "--steps", "2", "--batch", "4",
                          "--seq", "16", "--accum", "2", "--ckpt-every", "1",
                          "--ckpt-dir", str(tmp_path / "ck"), "--device",
                          "cpu"])
    assert res["final_step"] == 2 and res["restarts"] == 0
    assert res["accum"] == 2
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000001",
                                                   "step_00000002"]
