"""Model configuration dataclasses, the arch registry and ``reduced``.

A copy of the data half of ``repro.configs.base`` (the port imports nothing
from the JAX package): the same field names and defaults, so one config value
means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                      # hidden size of each expert FFN
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = True      # renormalize top-k probs (Mixtral-style)
    aux_loss_coef: float = 0.01
    every_k_layers: int = 1            # MoE block on layers where (i % k == offset)
    layer_offset: int = 0
    # Comet execution knobs (the paper's technique):
    impl: str = "comet"                # naive | coarse | comet | comet_hier
                                       # | dense
    ep: int = 0                        # expert-parallel group size; 0 = auto
    n_col_blocks: int = 0              # layer-1 N-decomposition; 0 = adaptive
    ring_group: int = 1                # source chunks fused per GroupGEMM step
    intra_group: int = 1               # comet_hier: devices per node — the
                                       # EP axis factors as inter-node ×
                                       # intra-node rings; 1 = flat
    wire_dtype: str = "fp32"           # comet_hier wire format for dispatch
                                       # payloads + combine partials (fp32 |
                                       # bf16 | fp8_e4m3); fp32 = native
                                       # width, no quantization
    fused_combine: bool = False        # comet: combine each column block as
                                       # it arrives (streaming layer-1
                                       # consumer) instead of after the
                                       # full-width concatenation
    gemm_impl: str = ""                # GroupGEMM backend (xla | pallas |
                                       # pallas_fused); "" = the static
                                       # "xla" default. Set by Plan.apply —
                                       # threaded explicitly, never via a
                                       # module global.
    coarse_chunks: int = 2             # FasterMoE-style pipeline degree
    # Adaptive transport autotuner (core/adaptive.py): path to a JSON plan
    # cache; "" disables lookup (the knobs above then apply verbatim). With a
    # cache configured, plan_override=True is the escape hatch pinning the
    # explicit knobs anyway.
    plan_cache: str = ""
    plan_override: bool = False
    plan_hw: str = ""                  # hardware key for plan lookup;
                                       # "" -> $REPRO_PLAN_HW or tpu_v5e
    plan_phase: str = "train"          # latency phase for plan lookup
                                       # (train | prefill | decode): serving
                                       # step builders set it so decode
                                       # resolves latency-ranked plans,
                                       # prefill chunk-throughput ones
    # BigMac-style descend-ascend experts (PAPERS.md): tokens are projected
    # d_model -> wire_dim by a shared descend matrix BEFORE dispatch and
    # back wire_dim -> d_model by a shared ascend matrix AFTER combine, so
    # both rings move wire_dim/d_model of the bytes. 0 = full-width experts.
    wire_dim: int = 0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk_size: int = 256
    dt_rank: int = 0                   # unused in SSD (per-head dt)


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    window: int = 0                    # 0 = full attention
    # pad q/kv heads up to model-axis divisibility so attention runs fully
    # head-sharded (TP) instead of sequence-sharded: dummy heads attend to
    # zero K/V and their outputs are dropped before the o-projection, so the
    # math is exact; costs extra SDPA FLOPs, removes the seq-TP dW
    # all-reduces (EXPERIMENTS.md §Perf cell 2).
    pad_heads: bool = False
    # long-seq handling: chunked online-softmax block size (pure-jnp flash)
    q_block: int = 512
    kv_block: int = 1024


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int                          # dense FFN hidden (0 for pure ssm / moe-only)
    vocab_size: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    activation: str = "swiglu"         # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # hybrid interleave: string over {'a','m'} of length `period`; layer i uses
    # pattern[i % period]. Empty = homogeneous.
    layer_pattern: str = ""
    # encoder-decoder (whisper): n_enc_layers encoder layers (bidirectional)
    n_enc_layers: int = 0
    frontend: str = "none"             # none | stub_audio | stub_patch
    # dtype policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    # memory policy
    remat: str = "full"                # full | none
    scan_layers: bool = True
    # sequence-parallel residual stream (Megatron SP): activations between
    # blocks are sharded over the model axis along seq, so norms/adds run
    # 1/model_size of the replicated traffic. Gathers happen where a block
    # needs the full sequence.
    sp_residual: bool = False
    # block-schedule IR (core/schedule.py): "" keeps the scanned
    # layer-at-a-time forward; "sequential" runs the IR in program order
    # (differencing baseline); "overlap" lets the scheduler legally reorder
    # segment emission across block boundaries. Numerics are identical in
    # all three — the IR only permutes emission over the same dataflow.
    block_schedule: str = ""

    # -- derived helpers ----------------------------------------------------
    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.every_k_layers) == self.moe.layer_offset

    def layer_kind(self, i: int) -> str:
        if not self.layer_pattern:
            return "m" if self.family == "ssm" else "a"
        return self.layer_pattern[i % len(self.layer_pattern)]

    def param_count(self) -> int:
        """Total parameter count (approximate, matches init_params)."""
        d = self.d_model
        total = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                  # lm head
        enc_layers = self.n_enc_layers
        for i in range(self.n_layers + enc_layers):
            is_enc = i >= self.n_layers
            kind = "a" if is_enc else self.layer_kind(i)
            if kind == "a" and self.attn is not None:
                a = self.attn
                q = d * a.n_heads * a.head_dim
                kv = 2 * d * a.n_kv_heads * a.head_dim
                o = a.n_heads * a.head_dim * d
                total += q + kv + o
                if a.qkv_bias:
                    total += (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
                if not is_enc and self.n_enc_layers and i < self.n_layers:
                    total += q + kv + o                  # cross-attention
            elif kind == "m" and self.ssm is not None:
                s = self.ssm
                d_in = s.expand * d
                nh = d_in // s.head_dim
                total += d * (2 * d_in + 2 * s.d_state + nh)  # in_proj(z,x)+B,C,dt
                total += s.conv_width * (d_in + 2 * s.d_state)
                total += nh + nh                          # A_log, D
                total += d_in * d                         # out_proj
            if (not is_enc) and self.is_moe_layer(i):
                m = self.moe
                total += d * m.num_experts                # router
                ne = m.num_experts + m.num_shared_experts
                total += ne * self.ffn_params(m.d_expert)
            elif self.d_ff > 0:
                total += self.ffn_params(self.d_ff)
            total += 2 * d                                # norms
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (for MODEL_FLOPS = 6*N_active*D)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        full_e = m.num_experts
        total = self.param_count()
        n_moe_layers = sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))
        per_expert = self.ffn_params(m.d_expert)
        total -= n_moe_layers * (full_e - m.top_k) * per_expert
        return total

    def ffn_params(self, hidden: int) -> int:
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        return mult * self.d_model * hidden


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode
    microbatch: int = 0                # 0 = no grad accumulation (train only)
    # paged KV cache (decode/serving shapes): page_size > 0 pools K/V as
    # n_pages shared fixed-size pages (page 0 = the null page) instead of
    # one seq_len region per slot, so seq_len becomes a per-request budget.
    # n_pages includes the null page; 0 = parity capacity
    # (slots * seq_len / page_size + 1)
    page_size: int = 0
    n_pages: int = 0

    @property
    def paged(self) -> bool:
        return self.page_size > 0

    @property
    def max_blocks(self) -> int:
        """Block-table entries of one request: seq_len / page_size."""
        if self.page_size <= 0 or self.seq_len % self.page_size:
            raise ValueError(f"page_size {self.page_size} does not tile "
                             f"seq_len {self.seq_len}")
        return self.seq_len // self.page_size

    def pages_total(self) -> int:
        return self.n_pages or self.global_batch * self.max_blocks + 1


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the archs)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs(include_smoke: bool = False) -> List[str]:
    import repro_torch.configs  # noqa: F401
    names = sorted(_REGISTRY)
    if not include_smoke:
        names = [n for n in names if not n.endswith("-smoke")]
    return names


ASSIGNED_ARCHS = [
    "granite-moe-3b-a800m",
    "qwen3-moe-235b-a22b",
    "llava-next-34b",
    "phi3-medium-14b",
    "nemotron-4-340b",
    "qwen2-0.5b",
    "qwen1.5-4b",
    "whisper-small",
    "jamba-v0.1-52b",
    "mamba2-780m",
]

PAPER_ARCHS = ["mixtral-8x7b", "qwen2-moe-2.7b", "phi3.5-moe"]


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build a reduced same-family smoke config."""
    changes: Dict = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2 * max(1, len(cfg.layer_pattern))),
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.attn is not None:
        changes["attn"] = dataclasses.replace(
            cfg.attn, n_heads=4,
            n_kv_heads=max(1, 4 * cfg.attn.n_kv_heads // cfg.attn.n_heads),
            head_dim=32, q_block=32, kv_block=32)
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8), d_expert=64,
            ep=1, wire_dim=64 if cfg.moe.wire_dim else 0)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=32, chunk_size=16)
    if cfg.n_enc_layers:
        changes["n_enc_layers"] = 2
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
