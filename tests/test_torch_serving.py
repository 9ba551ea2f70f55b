"""Serving parity: the port's ``ServeEngine.generate`` against the JAX
package's on smoke configs with bridged weights: MoE attention models, the
dense ones (phi3-medium, nemotron-4, qwen1.5, llava-next's language
model), the SSM family (mamba2) and the hybrid (jamba: attention, SSM and
MoE in one period). The token streams must be identical: more requests than slots
(slot reuse, SSM carries reset on re-admission), mixed prompt lengths,
prompts longer than the prefill chunk, and an eos that ends a request
early."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.serving import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serving import ServeEngine

# tiny shapes: one thread each, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

GEOM = dict(max_seq=64, batch_size=2, chunk=16)


def _cfgs(arch, gemm_impl):
    jcfg, cfg = jax_config(arch), get_config(arch)
    if gemm_impl:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, gemm_impl=gemm_impl))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, gemm_impl=gemm_impl))
    return jcfg, cfg


def _engines(arch, gemm_impl=""):
    jcfg, cfg = _cfgs(arch, gemm_impl)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(11))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return (JaxEngine(jcfg, params=jp, **GEOM),
            ServeEngine(cfg, params=tp, device="cpu", **GEOM))


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in lens]


@pytest.mark.parametrize("arch,eos_case", [("qwen2-moe-2.7b-smoke", True),
                                           ("granite-moe-3b-a800m-smoke",
                                            False),
                                           ("mamba2-780m-smoke", True),
                                           ("jamba-v0.1-52b-smoke", False),
                                           ("phi3.5-moe-smoke", False),
                                           ("qwen3-moe-235b-a22b-smoke",
                                            False),
                                           ("phi3-medium-14b-smoke", False),
                                           ("nemotron-4-340b-smoke", False),
                                           ("qwen1.5-4b-smoke", False),
                                           ("llava-next-34b-smoke", False),
                                           ("mixtral-8x7b-smoke", True)])
def test_token_streams_match_jax(arch, eos_case):
    jeng, teng = _engines(arch)
    prompts = _prompts(teng.cfg.vocab_size, [5, 23, 40, 9, 17])
    want = jeng.generate(prompts, max_new=6)
    got = teng.generate(prompts, max_new=6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.statuses == want.statuses == ["ok"] * 5
    assert got.prefill_tokens == want.prefill_tokens
    assert got.decode_steps == want.decode_steps
    if not eos_case:
        return
    # an eos taken from the stream ends that request early in both engines
    eos = int(want.tokens[1, 2])
    want = jeng.generate(prompts[:3], max_new=6, eos_id=eos)
    got = teng.generate(prompts[:3], max_new=6, eos_id=eos)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.lengths[1] <= 2


def test_fused_backend_token_streams_match_jax():
    jeng, teng = _engines("qwen2-moe-2.7b-smoke", "pallas_fused")
    prompts = _prompts(teng.cfg.vocab_size, [21, 6, 11], seed=1)
    want = jeng.generate(prompts, max_new=4)
    got = teng.generate(prompts, max_new=4)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_rejections_match_jax():
    jeng, teng = _engines("qwen2-moe-2.7b-smoke")
    prompts = [[], [1] * 70, [3, 4, 5]]
    want = jeng.generate(prompts, max_new=3)
    got = teng.generate(prompts, max_new=3)
    assert got.statuses == want.statuses == ["rejected", "rejected", "ok"]
    assert {i: e.reason.value for i, e in got.rejected.items()} == \
        {i: e.reason.value for i, e in want.rejected.items()}
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_serve_cli_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "qwen2-moe-2.7b-smoke", "--device", "cpu",
                      "--requests", "3", "--batch", "2", "--max-seq", "32",
                      "--chunk", "8", "--prompt-min", "3",
                      "--prompt-max", "12", "--max-new", "3",
                      "--gemm-impl", "pallas"])
    out = capsys.readouterr().out
    assert "req2 (len" in out and "decode steps" in out
    assert all(r.status.value == "ok" and len(r.tokens) == 3
               for r in eng.finished.values())


def test_serve_cli_serves_the_ssm_family(capsys):
    """--arch of the SSM family runs; --gemm-impl applies to configs with
    MoE layers only and is ignored here."""
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "mamba2-780m-smoke", "--device", "cpu",
                      "--requests", "3", "--batch", "2", "--max-seq", "48",
                      "--chunk", "16", "--prompt-min", "3",
                      "--prompt-max", "30", "--max-new", "3",
                      "--gemm-impl", "pallas"])
    assert "decode steps" in capsys.readouterr().out
    assert eng.cfg.moe is None
    assert all(r.status.value == "ok" and len(r.tokens) == 3
               for r in eng.finished.values())
