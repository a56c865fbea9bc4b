"""Deterministic synthetic LM data pipeline (a copy of
``repro.data.synthetic``: the same batches, bit for bit).

Produces a reproducible, seekable token stream (Zipf-ish unigram mixture +
Markov bigram structure so the LM loss actually decreases), sharded by host
and prefetched on a background thread. ``seek(step)`` gives exact resume
after restart — the fault-tolerance contract the train loop relies on.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np


class SyntheticLMStream:
    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1, prefetch: int = 2):
        assert batch % n_hosts == 0, "global batch must divide across hosts"
        self.vocab = vocab
        self.batch = batch // n_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.step = 0
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # bigram structure: next ~ 0.7 * (prev * a + c) mod V, else unigram
        rng = np.random.default_rng(seed)
        self._a = int(rng.integers(3, 97)) * 2 + 1
        self._c = int(rng.integers(1, vocab))
        zipf = 1.0 / np.arange(1, vocab + 1) ** 1.1
        self._unigram = zipf / zipf.sum()

    def seek(self, step: int):
        self.step = step

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + self.host_id)
        b, s, v = self.batch, self.seq_len, self.vocab
        first = rng.choice(v, size=(b, 1), p=self._unigram)
        toks = np.empty((b, s + 1), np.int64)
        toks[:, :1] = first
        noise = rng.random((b, s))
        fresh = rng.choice(v, size=(b, s), p=self._unigram)
        for t in range(s):
            structured = (toks[:, t] * self._a + self._c) % v
            toks[:, t + 1] = np.where(noise[:, t] < 0.7, structured, fresh[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    # -- synchronous API ----------------------------------------------------

    def next(self) -> Dict[str, np.ndarray]:
        batch = self._batch_at(self.step)
        self.step += 1
        return batch

    # -- prefetching iterator -------------------------------------------------

    def start_prefetch(self, depth: int = 2):
        self._queue = queue.Queue(maxsize=depth)
        self._stop.clear()

        def work():
            step = self.step
            while not self._stop.is_set():
                item = (step, self._batch_at(step))
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def next_prefetched(self) -> Dict[str, np.ndarray]:
        assert self._queue is not None, "call start_prefetch() first"
        step, batch = self._queue.get()
        self.step = step + 1
        return batch

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
