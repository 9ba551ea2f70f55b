"""Faults planted under the timed path, to show that the check catches
them (``run.py --fault <name>``, never in a measured run, and the CPU
tests). Each takes the thing it breaks and returns or alters it.

* ``unchanged``: a training step that returns its state unchanged;
* ``half_batch``: a training step on half of the batch, its loss and
  gradient the mean over the rest;
* ``flip_update``: a training step whose parameter update has the wrong
  sign (each parameter moved by minus what the step moved it), its
  optimizer state as the step left it;
* ``token``: every fifth decode step's tokens altered where the step
  makes them.
"""
from __future__ import annotations

import torch

from portbench.reference.model import leaves


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _restore(state, kept):
    """Writes ``kept`` back into ``state``'s own tensors (the step updates
    them in place), and its other entries over the step's."""
    if isinstance(state, dict):
        for k in state:
            if isinstance(state[k], (dict, list, torch.Tensor)):
                _restore(state[k], kept[k])
            else:
                state[k] = kept[k]
    elif isinstance(state, list):
        for a, b in zip(state, kept):
            _restore(a, b)
    else:
        with torch.no_grad():
            state.copy_(kept)


def unchanged(fn):
    def step(state, batch):
        kept = _host_copy(state)
        state, met = fn(state, batch)
        _restore(state, kept)
        return state, met
    return step


def flip_update(fn):
    def step(state, batch):
        before = [p.detach().clone() for _, p in leaves(state["params"])]
        state, met = fn(state, batch)
        with torch.no_grad():
            for (_, p), b in zip(leaves(state["params"]), before):
                p.copy_(2 * b - p)
        return state, met
    return step


def half_batch(fn):
    def step(state, batch):
        return fn(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return step


def token(eng):
    orig = eng.decode["fn"]
    calls = [0]

    def fn(*a, **kw):
        got, logits, cache = orig(*a, **kw)
        calls[0] += 1
        if calls[0] % 5 == 0:
            got = got.clone()
            got[:, 0] = (got[:, 0] + 1) % logits.shape[-1]
        return got, logits, cache
    eng.decode["fn"] = fn


TRAIN = {"unchanged": unchanged, "half_batch": half_batch,
         "flip_update": flip_update}
SERVE = {"token": token}
