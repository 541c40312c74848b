"""Deterministic synthetic token stream (host-sharded, restart-exact).

A copy of ``repro.data.synthetic`` (numpy only), so that both packages
draw the same batches bitwise from one seed.

Every (step, host) pair maps to an independent PCG64 stream, so data is
* deterministic across restarts (fault-tolerance requirement: resuming from a
  checkpoint at step k replays exactly the batches k, k+1, ...),
* disjoint across hosts (each host draws only its shard of the global batch),
* independent of the number of hosts *for a fixed shard layout* (elastic
  restarts re-slice the same global stream).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    d_model: int = 0  # for frame/image stubs
    enc_seq: int = 0
    img_seq: int = 0

    def _rng(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row])
        )

    def global_batch_at(self, step: int) -> dict:
        return self.shard_at(step, 0, 1)

    def shard_at(self, step: int, host: int, n_hosts: int) -> dict:
        """Rows [host::n_hosts] of the global batch for ``step``."""
        assert self.global_batch % n_hosts == 0
        rows = range(host, self.global_batch, n_hosts)
        toks = np.stack(
            [self._rng(step, r).integers(0, self.vocab_size,
                                         size=self.seq_len + 1,
                                         dtype=np.int32) for r in rows]
        )
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.enc_seq:
            out["frames"] = np.stack([
                self._rng(step, r).standard_normal(
                    (self.enc_seq, self.d_model)).astype(np.float32) * 0.02
                for r in rows
            ])
        if self.img_seq:
            out["images"] = np.stack([
                self._rng(step, r).standard_normal(
                    (self.img_seq, self.d_model)).astype(np.float32) * 0.02
                for r in rows
            ])
        return out


def make_synthetic(cfg, shape, seed: int = 0) -> SyntheticLM:
    return SyntheticLM(
        vocab_size=cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        d_model=cfg.d_model,
        enc_seq=cfg.enc_seq if cfg.family == "audio" else 0,
        img_seq=cfg.img_seq if cfg.family == "vlm" else 0,
    )
