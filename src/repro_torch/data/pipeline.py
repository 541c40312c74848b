"""Data pipeline: background prefetch + optional binary token files.

A copy of ``repro.data.pipeline`` (numpy only); the batches it yields are
numpy, put on the device by the caller.

``PrefetchIterator`` overlaps host-side batch construction with device steps
(double buffering).  ``BinTokenDataset`` memory-maps a flat uint16/uint32
token file (the standard packed-LM format) and serves deterministic windows;
``SyntheticLM`` is the default source.  Iterator state is just ``step`` —
checkpointable as a single integer.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class BinTokenDataset:
    """Flat packed token file; window ``i`` = tokens[i*S : i*S + S + 1]."""

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 dtype=np.uint16, seed: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.n_windows = (len(self.tokens) - 1) // seq_len
        self.seed = seed
        if self.n_windows < 1:
            raise ValueError("dataset smaller than one window")

    def shard_at(self, step: int, host: int = 0, n_hosts: int = 1) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        idx = rng.integers(0, self.n_windows, size=self.global_batch)
        idx = idx[host::n_hosts]
        s = self.seq_len
        rows = np.stack([
            np.asarray(self.tokens[i * s: i * s + s + 1], dtype=np.int32)
            for i in idx
        ])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


class PrefetchIterator:
    """Background-thread prefetch of ``source.shard_at(step, ...)``."""

    def __init__(self, source, start_step: int = 0, host: int = 0,
                 n_hosts: int = 1, depth: int = 2):
        self.source = source
        self.host = host
        self.n_hosts = n_hosts
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next_to_produce = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.source.shard_at(self._next_to_produce, self.host,
                                         self.n_hosts)
            step = self._next_to_produce
            self._next_to_produce += 1
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def close(self):
        self._stop.set()
