"""Deterministic synthetic data with background prefetch, a numpy copy of
``repro.data.synthetic``: every batch is a pure function of (seed, step)
and bit-identical to the JAX package's, so a run restored at step k sees
the batches k, k+1, ... that the interrupted run would have seen.

The batch shapes come from ``launch/specs.train_batch_specs``.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Tuple

import numpy as np

class SyntheticLM:
    def __init__(self, cfg, shape_structs: Dict[str, Tuple[int, ...]],
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        self.cfg = cfg
        self.structs = shape_structs
        self.seed = seed
        self.pidx = process_index
        self.pcount = process_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.pidx]))
        out: Dict[str, np.ndarray] = {}
        if "tokens" in self.structs:
            # correlated stream so models actually learn: labels = next token
            shape = tuple(self.structs["tokens"])
            stream = self._markov(rng, shape, self.cfg.vocab_size)
            out["tokens"] = stream
            if "labels" in self.structs:
                lab = np.roll(stream, -1, axis=-1)
                lab[..., -1] = 0
                out["labels"] = lab
        elif "labels" in self.structs:                # vlm: embeds + labels
            shape = tuple(self.structs["labels"])
            out["labels"] = rng.integers(0, self.cfg.vocab_size, size=shape,
                                         dtype=np.int32)
        for name in ("embeds", "frames"):
            if name in self.structs:
                shape = tuple(self.structs[name])
                out[name] = rng.standard_normal(shape).astype(
                    np.float32) * 0.02
        return out

    @staticmethod
    def _markov(rng, shape, vocab):
        """Cheap learnable structure: x[t+1] = (a*x[t] + b + noise) % vocab."""
        x = rng.integers(0, vocab, size=shape[:-1] + (1,), dtype=np.int64)
        seq = [x]
        a, b = 31, 17
        for _ in range(shape[-1] - 1):
            nxt = (a * seq[-1] + b + rng.integers(0, 3, size=x.shape)) % vocab
            seq.append(nxt)
        return np.concatenate(seq, axis=-1).astype(np.int32)


class Prefetcher:
    """Background-thread prefetch: host batch synthesis overlaps device
    compute."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.source.batch_at(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)
