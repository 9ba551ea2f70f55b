"""A request's prefill bits do not depend on the stack it is admitted in.

The serving engine prefills the requests it admits in one step as one
stacked ``lm.prefill_chunk`` call per chunk. On the card the router's fp32
product and the fp32 LM head took other bits at another row count
(``chip_smoke.py --only build,stack_bits``), so a request admitted alone
streamed otherwise than in a stack, and a quarantine, a cancel or a
prefill worker that moved an admission changed a stream. The port takes
those products per request (``routing.router_logits``, ``lm._logits(...,
per_row=True)``). This test holds that structure on the CPU: one request's
last-chunk logits and its 8-token stream are bit-identical alone and in
stacks of 2, 4 and 8, at the first and at the last row, on
qwen2-moe-2.7b-smoke and granite-moe-3b-a800m-smoke at no-drop capacity
(a dropping capacity routes by the stack's token count, in the JAX
package too).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving import ServeEngine

torch.set_num_threads(1)

ARCHS = ("qwen2-moe-2.7b-smoke", "granite-moe-3b-a800m-smoke")
CHUNK, MAX_SEQ, SLOTS, MAX_NEW = 8, 64, 8, 8
PLEN = 13                         # two chunks, the last one partial


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = lm.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=PLEN).tolist()
               for _ in range(SLOTS)]
    return cfg, params, prompts


def _stack(arch, A, pos):
    """The prompts of a stack of A with request 0 at row ``pos``."""
    _, _, prompts = _setup(arch)
    others = prompts[1:A]
    return others[:pos] + [prompts[0]] + others[pos:]


def _last_chunk_logits(arch, A, pos):
    """Request 0's logits from its last chunk, prefilled chunk by chunk
    in a stack of A as the engine stacks an admission round."""
    cfg, params, _ = _setup(arch)
    toks = torch.tensor(_stack(arch, A, pos))
    cache = lm.init_cache(cfg, SLOTS, MAX_SEQ, "cpu")
    logits = None
    for j in range(0, PLEN, CHUNK):
        part = torch.zeros((A, CHUNK), dtype=torch.long)
        n = min(CHUNK, PLEN - j)
        part[:, :n] = toks[:, j:j + n]
        logits, _ = lm.prefill_chunk(cfg, params, cache, part,
                                     torch.full((A,), j),
                                     torch.full((A,), n), torch.arange(A))
    return logits[pos]


def _stream(arch, A, pos):
    """Request 0's tokens from an engine that admits the whole stack in
    one round."""
    cfg, params, _ = _setup(arch)
    eng = ServeEngine(cfg, params=params, max_seq=MAX_SEQ,
                      batch_size=SLOTS, chunk=CHUNK, device="cpu")
    rids = [eng.submit(p, max_new=MAX_NEW) for p in _stack(arch, A, pos)]
    eng.run()
    assert eng.admit_rounds == 1
    return eng.finished[rids[pos]].tokens


@functools.lru_cache(maxsize=None)
def _alone(arch):
    return _last_chunk_logits(arch, 1, 0), _stream(arch, 1, 0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("A,pos", [(2, 0), (2, 1), (4, 0), (4, 3), (8, 0),
                                   (8, 7)])
def test_prefill_bits_independent_of_stack(arch, A, pos):
    logits, stream = _alone(arch)
    assert torch.equal(_last_chunk_logits(arch, A, pos), logits)
    got = _stream(arch, A, pos)
    assert len(got) == MAX_NEW and got == stream
