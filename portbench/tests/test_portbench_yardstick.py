"""The frozen yardstick: each copy pinned to the figures it was copied
from (the phase-21 step's kernel shapes: qwen2-moe-2.7b, 4 x 1,024 tokens,
64 experts at 320 capacity rows, d 2,048, f 1,408) and to the original's
output, and the trace and traffic arithmetic on small cases."""
import json

import numpy as np
import pytest

from portbench.tests.conftest import REPO
from portbench.yardstick import costs, kernels as K, stats
from portbench.yardstick import traffic as TR


# (frozen cost, roofline.py original, the bound in ms PERF.md's kernel
# table gives for that call)
def _pins():
    from repro_torch.analysis import roofline as R
    return [
        (costs.fused_mlp_cost(64, 320, 2048, 1408, 2048),
         R.fused_mlp_cost(64, 320, 2048, 1408, 2048), 0.3806),
        (costs.fused_mlp_bwd_cost("fused_mlp_dgrad", 64, 320, 2048, 1408,
                                  2048),
         R.fused_mlp_bwd_cost("fused_mlp_dgrad", 64, 320, 2048, 1408, 2048),
         0.5971),
        (costs.fused_mlp_bwd_cost("fused_mlp_wgrad", 64, 320, 2048, 1408,
                                  2048),
         R.fused_mlp_bwd_cost("fused_mlp_wgrad", 64, 320, 2048, 1408, 2048),
         0.7166),
        (costs.topk_combine_cost(2048, 4, 2048),
         R.topk_combine_cost(2048, 4, 2048), 0.0125),
        (costs.grouped_gemm_cost(64, 160, 2048, 1408),
         R.grouped_gemm_cost(64, 160, 2048, 1408), 0.1313),
    ]


@pytest.mark.parametrize("i", range(5))
def test_cost_copies_pinned(i):
    frozen, orig, ms = _pins()[i]
    assert (frozen.bytes, frozen.flops, frozen.peak) == \
        (orig.bytes, orig.flops, orig.peak)
    assert round(frozen.bound_s() * 1e3, 4) == ms


def test_moe_bound_prices_routed_rows_and_hit_experts():
    full = costs.fused_mlp_cost(4, 8, 64, 32, 64).bound_s()
    assert costs.moe_call_bound("fused_mlp", [8] * 4, 64, 32, 64, True,
                                2) == pytest.approx(full)
    # an expert with no row costs nothing, not even its weights
    half = costs.moe_call_bound("fused_mlp", [8, 8, 0, 0], 64, 32, 64,
                                True, 2)
    assert half == pytest.approx(full / 2)


@pytest.mark.parametrize("conf", ["qwen2-moe-2.7b-l4", "jamba-v0.1-52b-p1"])
def test_active_params_against_the_programs_count(conf):
    """The frozen count leaves out what is no matrix product: the
    embedding lookup, the norms, and the SSM's depthwise convolution and
    its A_log and D, which the program's ``active_param_count``
    includes."""
    from portbench import adapter
    c = json.loads((REPO / "portbench" / "configs" / f"{conf}.json")
                   .read_text())
    cfg = adapter.program_config(c)
    m = c["model"]
    norms = 2 * m["d_model"] * m["n_layers"]
    embed = m["vocab_size"] * m["d_model"]
    n_ssm = sum(costs.layer_kind(m, i) == "m" for i in range(m["n_layers"]))
    if n_ssm:
        s = m["ssm"]
        d_in = s["expand"] * m["d_model"]
        norms += n_ssm * (s["conv_width"] * (d_in + 2 * s["d_state"])
                          + 2 * d_in // s["head_dim"])
    assert costs.active_params(m) + embed + norms == \
        cfg.active_param_count()


def test_train_flops_adds_attention():
    m = json.loads((REPO / "portbench/configs/qwen2-moe-2.7b-l4.json")
                   .read_text())["model"]
    base = 6.0 * costs.active_params(m) * 8192
    attn = 3 * 4 * 2 * 2 * 16 * 128 * 2 * 4096 * 4097 // 2
    assert costs.train_flops(m, 2, 4096) == pytest.approx(base + attn)
    assert costs.train_flops(m, 2, 4096) / 8192 == pytest.approx(3.3046e9,
                                                                 rel=1e-4)


def test_union_gaps_and_labels():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert K.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert K.covered(iv) == pytest.approx(3.0)
    assert K.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    lab = K.label_gaps([(2.0, 3.0)], [("step", 1.5, 2.5), ("host", 2.2,
                                                           2.4)])
    assert lab == pytest.approx({"step": 0.3, "host": 0.2,
                                 "outside any span": 0.5})


def test_idle_is_a_union_not_a_sum():
    """Two streams busy at once count once (the port's roofline module's
    sum would count them twice)."""
    rec = {"kernels": [("gemm", 0.0, 1.0), ("ncclKernel", 0.0, 1.0)],
           "window_s": 2.0}
    rec["busy"] = K.union([(s, e) for _, s, e in rec["kernels"]])
    rec["busy_s"] = K.covered(rec["busy"])
    assert K.idle_percent(rec) == pytest.approx(50.0)
    assert K.share_of_busy(rec, {"nccl"}) == pytest.approx(100.0)


def test_groups():
    assert K.group_of("void fused_mlp_hopper_kernel<128>(...)") == \
        "fused_mlp"
    assert K.group_of("recompute_kernel") == "fused_mlp_recompute"
    assert K.group_of("grouped_gemm_hopper_kernel") == "grouped_gemm"
    assert K.group_of("ncclDevKernel_AllGather") == "nccl"
    assert K.group_of("sm90_xmma_gemm_bf16") == "library_gemm"


@pytest.mark.parametrize("p", [50, 90, 95, 99])
def test_percentile_is_over_all_values(p):
    v = np.random.default_rng(p).exponential(size=137)
    assert stats.percentile(v, p) == pytest.approx(np.percentile(v, p))
    assert stats.rate(250, 10.0) == 25.0


def test_markov_batches_are_the_programs():
    from repro_torch.data.synthetic import SyntheticLM

    class Cfg:
        vocab_size = 151936
    src = SyntheticLM(Cfg(), {"tokens": (2, 64), "labels": (2, 64)},
                      seed=2 ** 33 + 1)
    got = TR.train_batch(2 ** 33 + 1, 5, 2, 64, 151936)
    want = src.batch_at(5)
    for k in ("tokens", "labels"):
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("mix", ["offline-batch", "chat-poisson"])
def test_traffic_same_work_for_every_seed(mix):
    """Every block of 64 holds the same sizes for every seed; a mix with a
    ``schedule_seed`` also keeps their order and its arrival times, and
    the seed changes only the prompts' token ids."""
    traf = json.loads((REPO / f"portbench/traffic/{mix}.json").read_text())
    a = TR.requests(1, traf, 65536, 128)
    b = TR.requests(2 ** 40 + 3, traf, 65536, 128)
    for blk in (slice(0, 64), slice(64, 128)):
        assert sorted(len(r.prompt) for r in a[blk]) == \
            sorted(len(r.prompt) for r in b[blk])
        assert sorted(r.max_new for r in a[blk]) == \
            sorted(r.max_new for r in b[blk])
    fixed = "schedule_seed" in traf
    assert ([len(r.prompt) for r in a] == [len(r.prompt) for r in b]) == fixed
    assert not np.array_equal(a[0].prompt[:16], b[0].prompt[:16])
    lens = [len(r.prompt) for r in a]
    assert min(lens) >= 256 and max(lens) <= 2048
    again = TR.requests(1, traf, 65536, 128)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, again))
    if "arrivals" in traf:
        gaps_a = np.diff([0.0] + [r.arrival_s for r in a[:64]])
        assert (gaps_a > 0).all()
        assert a[63].arrival_s == pytest.approx(b[63].arrival_s)
        assert 64 / a[63].arrival_s == pytest.approx(
            traf["arrivals"]["rate_per_s"], rel=0.05)
