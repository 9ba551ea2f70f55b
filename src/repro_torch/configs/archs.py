"""Assigned architectures (10) + the paper's evaluation models (3).

Every register() also registers a ``<name>-smoke`` reduced config of the same
family for CPU tests. Sources are noted per config; dims follow the assignment
sheet verbatim.
"""
from __future__ import annotations

from repro_torch.configs.base import (AttnConfig, ModelConfig, MoEConfig,
                                      SSMConfig, reduced, register)


def _reg(name, build):
    register(name)(build)
    register(name + "-smoke")(lambda: reduced(build()))


# --- granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base] --------
def granite():
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, d_ff=0, vocab_size=49155,
        attn=AttnConfig(n_heads=24, n_kv_heads=8, head_dim=64),
        moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
        activation="swiglu", tie_embeddings=True)


# --- granite-moe-bigmac [arXiv:2408.eprint BigMac-style descend-ascend] ------
# Same skeleton as granite-moe-3b-a800m but experts read/write a narrow
# wire_dim=384 (= d_model/4) bus: a shared descend projection before dispatch
# and ascend after combine, shrinking all-to-all traffic 4x.
def bigmac():
    return ModelConfig(
        name="granite-moe-bigmac", family="moe",
        n_layers=32, d_model=1536, d_ff=0, vocab_size=49155,
        attn=AttnConfig(n_heads=24, n_kv_heads=8, head_dim=64),
        moe=MoEConfig(num_experts=40, top_k=8, d_expert=512, wire_dim=384),
        activation="swiglu", tie_embeddings=True)


# --- qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B] ---------------------------
def qwen3moe():
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, d_ff=0, vocab_size=151936,
        attn=AttnConfig(n_heads=64, n_kv_heads=4, head_dim=128),
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536),
        activation="swiglu")


# --- llava-next-34b (Yi/Hermes backbone) [vlm; anyres frontend stubbed] ------
def llava():
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, d_ff=20480, vocab_size=64000,
        attn=AttnConfig(n_heads=56, n_kv_heads=8, head_dim=128),
        activation="swiglu", frontend="stub_patch")


# --- phi3-medium-14b [arXiv:2404.14219] --------------------------------------
def phi3():
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, d_ff=17920, vocab_size=100352,
        attn=AttnConfig(n_heads=40, n_kv_heads=10, head_dim=128),
        activation="swiglu")


# --- nemotron-4-340b [arXiv:2402.16819] — squared-ReLU, GQA ------------------
def nemotron():
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, d_ff=73728, vocab_size=256000,
        attn=AttnConfig(n_heads=96, n_kv_heads=8, head_dim=192),
        activation="relu2", norm="layernorm")


# --- qwen2-0.5b [arXiv:2407.10671] — QKV bias, tied embeddings ---------------
def qwen2_05b():
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, d_ff=4864, vocab_size=151936,
        attn=AttnConfig(n_heads=14, n_kv_heads=2, head_dim=64, qkv_bias=True),
        activation="swiglu", tie_embeddings=True)


# --- qwen1.5-4b [hf:Qwen/Qwen1.5-4B] — QKV bias, MHA (kv == heads) -----------
def qwen15_4b():
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, d_ff=6912, vocab_size=151936,
        attn=AttnConfig(n_heads=20, n_kv_heads=20, head_dim=128, qkv_bias=True),
        activation="swiglu")


# --- whisper-small [arXiv:2212.04356] — enc-dec, conv frontend stubbed -------
def whisper():
    return ModelConfig(
        name="whisper-small", family="audio",
        n_layers=12, n_enc_layers=12, d_model=768, d_ff=3072, vocab_size=51865,
        attn=AttnConfig(n_heads=12, n_kv_heads=12, head_dim=64, rope_theta=0.0),
        activation="gelu", norm="layernorm", frontend="stub_audio")


# --- jamba-v0.1-52b [arXiv:2403.19887] — attn:mamba 1:7, MoE 16e top-2 -------
def jamba():
    # period 8: attention at offset 4 (attn_layer_period=8, offset=4);
    # MoE every 2nd layer at odd offsets (expert_layer_period=2, offset=1).
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, d_ff=14336, vocab_size=65536,
        attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128, rope_theta=0.0),
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336,
                      every_k_layers=2, layer_offset=1),
        ssm=SSMConfig(d_state=16, expand=2, head_dim=64, conv_width=4),
        layer_pattern="mmmmammm",
        activation="swiglu")


# --- mamba2-780m [arXiv:2405.21060] — SSD, attention-free --------------------
def mamba2():
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, d_ff=0, vocab_size=50280,
        attn=None,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_width=4),
        layer_pattern="m", activation="swiglu")


# --- paper models (Table 2) --------------------------------------------------
def mixtral():
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, d_ff=0, vocab_size=32000,
        attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128),
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336),
        activation="swiglu")


def qwen2moe():
    return ModelConfig(
        name="qwen2-moe-2.7b", family="moe",
        n_layers=24, d_model=2048, d_ff=0, vocab_size=151936,
        attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=4, d_expert=1408),
        activation="swiglu")


def phi35moe():
    return ModelConfig(
        name="phi3.5-moe", family="moe",
        n_layers=32, d_model=4096, d_ff=0, vocab_size=32064,
        attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128),
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=6400),
        activation="swiglu")


_reg("granite-moe-3b-a800m", granite)
_reg("granite-moe-bigmac", bigmac)
_reg("qwen3-moe-235b-a22b", qwen3moe)
_reg("llava-next-34b", llava)
_reg("phi3-medium-14b", phi3)
_reg("nemotron-4-340b", nemotron)
_reg("qwen2-0.5b", qwen2_05b)
_reg("qwen1.5-4b", qwen15_4b)
_reg("whisper-small", whisper)
_reg("jamba-v0.1-52b", jamba)
_reg("mamba2-780m", mamba2)
_reg("mixtral-8x7b", mixtral)
_reg("qwen2-moe-2.7b", qwen2moe)
_reg("phi3.5-moe", phi35moe)
