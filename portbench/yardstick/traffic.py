"""Seeded inputs: training batches and serving traffic.

``markov_tokens`` is a frozen copy of the port's ``data/synthetic.py``
(``SyntheticLM._markov`` and its labels): each batch is a pure function of
(seed, step). Serving traffic is drawn so that every seed does the same
amount of work: request sizes and inter-arrival gaps come in blocks of
``block`` requests, each block holding the same stratified quantiles of
the traffic's distributions, in an order that the seed shuffles. Only the
order and the prompts' token ids depend on the seed; a mix whose tails
turn on the order of long and short requests fixes the order
(``schedule_seed``), so that every seed does the same work in the same
schedule.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def markov_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """x[t+1] = (31 x[t] + 17 + noise) % vocab, noise in {0, 1, 2}."""
    x = rng.integers(0, vocab, size=tuple(shape[:-1]) + (1,), dtype=np.int64)
    seq = [x]
    for _ in range(shape[-1] - 1):
        nxt = (31 * seq[-1] + 17 + rng.integers(0, 3, size=x.shape)) % vocab
        seq.append(nxt)
    return np.concatenate(seq, axis=-1).astype(np.int32)


def train_batch(seed: int, step: int, batch: int, seq: int,
                vocab: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch: tokens (batch, seq) and next-token labels,
    the last label 0 (``SyntheticLM.batch_at`` of process 0)."""
    tokens = markov_tokens(_rng(seed, step, 0), (batch, seq), vocab)
    labels = np.roll(tokens, -1, axis=-1)
    labels[..., -1] = 0
    return {"tokens": tokens, "labels": labels}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Request:
    prompt: np.ndarray        # int64 token ids
    max_new: int
    arrival_s: float          # offset from the start of the schedule


def _quantiles(n: int) -> np.ndarray:
    """n stratified probabilities, the midpoints of n equal strata."""
    return (np.arange(n) + 0.5) / n


def log_uniform(lo: int, hi: int, q: np.ndarray) -> np.ndarray:
    return np.floor(np.exp(math.log(lo) + q * (math.log(hi + 1)
                                               - math.log(lo)))).astype(
        np.int64).clip(lo, hi)


def uniform_int(lo: int, hi: int, q: np.ndarray) -> np.ndarray:
    return np.floor(lo + q * (hi - lo + 1)).astype(np.int64).clip(lo, hi)


def requests(seed: int, traffic: Dict, vocab: int, n: int) -> List[Request]:
    """The first ``n`` requests of a traffic mix: ``prompt`` and ``output``
    ({"dist": "log_uniform" | "uniform", "lo", "hi"}), optional
    ``arrivals`` ({"process": "poisson", "rate_per_s"}; without it every
    request is due at 0), ``block``, the number of requests that share
    one stratified set of sizes and gaps, and ``schedule_seed``: where
    given, the order of sizes and gaps is drawn from it and is the same for
    every run seed, which then sets the prompts' token ids alone."""
    block = int(traffic.get("block", 64))
    q = _quantiles(block)
    draw = {"log_uniform": log_uniform, "uniform": uniform_int}
    p, o = traffic["prompt"], traffic["output"]
    plens = draw[p["dist"]](p["lo"], p["hi"], q)
    olens = draw[o["dist"]](o["lo"], o["hi"], q)
    arr = traffic.get("arrivals")
    gaps = (-np.log1p(-q) / float(arr["rate_per_s"]) if arr
            else np.zeros(block))
    if arr and arr.get("process", "poisson") != "poisson":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    fixed = traffic.get("schedule_seed")
    rng = _rng(seed, 1)
    order_rng = rng if fixed is None else _rng(fixed, 2)
    out: List[Request] = []
    t = 0.0
    while len(out) < n:
        order = [order_rng.permutation(block) for _ in range(3)]
        for i in range(block):
            t += float(gaps[order[2][i]])
            plen = int(plens[order[0][i]])
            prompt = rng.integers(0, vocab, size=plen, dtype=np.int64)
            out.append(Request(prompt, int(olens[order[1][i]]),
                               t if arr else 0.0))
            if len(out) == n:
                break
    return out
