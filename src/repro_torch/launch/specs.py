"""Train batch shapes for every (arch x shape) cell (the port's copy of
``repro.launch.specs``), the batch's partition specs on a mesh, and this
rank's rows of a global batch; the monolithic prefill's batch and its
specs (``prefill_batch_specs``, ``prefill_batch_pspecs``); the decode
cache's shapes and specs, which the serving steps share
(``decode_inputs``).
"""
from __future__ import annotations

from typing import Dict, Tuple

# default grad-accumulation per train shape name (microbatch count)
TRAIN_ACCUM = {"train_4k": 8, "smoke": 1}
WHISPER_DEC_RATIO = 4          # decoder text length = seq_len // ratio
WHISPER_ENC_LEN_DECODE = 4096  # encoder frames cached during decode


def legal_accum(global_batch: int, accum: int) -> int:
    """The largest microbatch count <= accum that divides the batch."""
    while accum > 1 and global_batch % accum:
        accum -= 1
    return max(1, accum)


def train_batch_specs(cfg, shape, accum: int) -> Dict[str, Tuple[int, ...]]:
    """The shape of each entry of one train batch; leading dims (accum,
    microbatch, seq), or (microbatch, seq) without accumulation."""
    B, S = shape.global_batch, shape.seq_len
    accum = legal_accum(B, accum)
    mb = B // accum

    def shp(*tail):
        return (accum, mb) + tail if accum > 1 else (mb,) + tail

    if cfg.family == "vlm":
        return {"embeds": shp(S, cfg.d_model), "labels": shp(S)}
    if cfg.n_enc_layers:                            # whisper
        Sd = max(64, S // WHISPER_DEC_RATIO)
        return {"frames": shp(S, cfg.d_model), "tokens": shp(Sd),
                "labels": shp(Sd)}
    return {"tokens": shp(S), "labels": shp(S)}


def prefill_batch_specs(cfg, shape) -> Dict[str, Tuple[int, ...]]:
    """The shape of each entry of one monolithic-prefill batch
    (``repro/launch/specs.py:71-77``): the train batch's of ``shape``
    without accumulation and without labels (an encoder-decoder's:
    "frames" (B, S, d) and "tokens" (B, max(64, S // 4))). A batch of
    mixed lengths adds a "mask" of the tokens' shape (left padding)."""
    structs = train_batch_specs(cfg, shape, 1)
    structs.pop("labels", None)
    return structs


def prefill_batch_pspecs(cfg, shape, ctx) -> Dict:
    """The partition spec of each entry of ``prefill_batch_specs`` on
    ``ctx``'s mesh (``repro/launch/train_step.py:167-168``): the rows
    split over the dp axes where they split as the decode cache's slots
    of the same count do (``sharding.slots_cut``: the stitch then writes
    each dp rank's rows into its own slots), whole on every rank
    otherwise; the rest of each entry whole. A left-padded batch's "mask"
    is cut as its "tokens"."""
    from repro_torch.parallel.sharding import P, slots_cut
    dp = ctx.dp_axes if len(ctx.dp_axes) != 1 else ctx.dp_axes[0]
    b = dp if slots_cut(ctx, shape.global_batch) else None
    specs = {k: P(*((b,) + (None,) * (len(v) - 1)))
             for k, v in prefill_batch_specs(cfg, shape).items()}
    if "tokens" in specs:
        specs["mask"] = specs["tokens"]
    return specs


def train_batch_pspecs(cfg, shape, accum: int,
                       dp_axes: Tuple[str, ...] = ("data",)) -> Dict:
    """The partition spec of each entry of ``train_batch_specs``: the
    microbatch rows split over ``dp_axes`` (the leading (accum,) axis and
    the rest whole), as the JAX package's ``train_batch_specs`` gives
    them."""
    from repro_torch.parallel.sharding import P
    dp = (dp_axes if len(dp_axes) != 1 else dp_axes[0]) or None
    lead = (None, dp) if legal_accum(shape.global_batch, accum) > 1 \
        else (dp,)
    return {k: P(*(lead + (None,) * (len(v) - len(lead))))
            for k, v in train_batch_specs(cfg, shape, accum).items()}


def local_batch(batch: Dict, pspecs: Dict, mesh) -> Dict:
    """This rank's rows of a global batch (numpy arrays or tensors), cut
    as ``pspecs`` says."""
    import torch

    from repro_torch.parallel.sharding import shard_leaf
    return {k: shard_leaf(torch.as_tensor(v), pspecs[k], mesh)
            for k, v in batch.items()}


def enc_len_decode(cfg) -> int:
    """The encoder rows a decode cache of ``cfg`` holds: 0 but for an
    encoder-decoder (``WHISPER_ENC_LEN_DECODE``)."""
    return WHISPER_ENC_LEN_DECODE if cfg.n_enc_layers else 0


def decode_inputs(cfg, shape, ctx) -> Tuple:
    """(cache shapes, cache specs, the decode tokens' spec) of the decode
    cache that ``shape`` (global_batch slots of seq_len positions)
    describes (``repro/launch/specs.py:80-101``). The shapes are global:
    a tuple over period positions of {entry: (shape, dtype)}, as
    ``lm.cache_shapes`` gives them; the specs are
    ``parallel.sharding.cache_specs`` (every entry replicated without a
    mesh). One shape gives the prefill and decode steps the same layout.
    ``shape.page_size`` > 0 switches to the paged layout
    (``lm.paged_cache_shapes`` of ``shape.pages_total()`` pages,
    ``sharding.paged_cache_specs``). An encoder-decoder's cache holds
    ``WHISPER_ENC_LEN_DECODE`` rows of encoder K/V (``repro/launch/
    specs.py:92-95``), cut on a mesh as ``cache_specs(enc_len=)`` says."""
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.sharding import P
    B, S = shape.global_batch, shape.seq_len
    ranked = ctx is not None and ctx.active
    enc_len = enc_len_decode(cfg)
    if shape.paged:
        cache = lm.paged_cache_shapes(cfg, B, shape.pages_total(),
                                      shape.page_size)
    else:
        cache = lm.cache_shapes(cfg, B, S, enc_len)
    if ranked:
        cspecs = (SH.paged_cache_specs(cfg, ctx, B) if shape.paged
                  else SH.cache_specs(cfg, ctx, B, S, enc_len))
        dp = ctx.dp_axes if len(ctx.dp_axes) != 1 else ctx.dp_axes[0]
        tok_spec = P(dp if SH.slots_cut(ctx, B) else None, None)
    else:
        cspecs = tuple({k: P(*(None,) * len(v[0])) for k, v in e.items()}
                       for e in cache)
        tok_spec = P(None, None)
    return cache, cspecs, tok_spec
