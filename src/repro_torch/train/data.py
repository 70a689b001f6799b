"""Deterministic synthetic LM data pipeline with checkpointable state — the
port's copy of the JAX package's ``train/data.py`` (plain NumPy; the same
seed gives byte-identical batches).

Restart safety: the stream is a pure function of (seed, step), so restoring
``state_dict()`` after a crash reproduces the exact token sequence — the
data-side half of the fault-tolerance story (the checkpoint holds the
optimizer step and the data cursor; no replayed or skipped batches).

Tokens follow a Zipf-like marginal with a Markov bigram twist so the loss
is learnable (structure to memorize) but not trivially constant.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed << 32) ^ step)

    def next_batch(self) -> dict[str, np.ndarray]:
        rng = self._rng(self.step)
        self.step += 1
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        # Zipf marginal, clipped to vocab
        base = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        tokens = (base % v).astype(np.int32)
        # Markov twist: with p=0.5 the next token = f(prev) (learnable bigram)
        follow = rng.random((b, s)) < 0.5
        nxt = ((tokens[:, :-1] * 31 + 7) % v).astype(np.int32)
        tokens[:, 1:] = np.where(follow, nxt, tokens[:, 1:])
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:].copy()}

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])


@dataclasses.dataclass
class ShardedLoader:
    """Wraps SyntheticLM for multi-host: each host materializes only its
    shard of the global batch (host_id over num_hosts), same cursor."""

    stream: SyntheticLM
    host_id: int = 0
    num_hosts: int = 1

    def next_batch(self) -> dict[str, np.ndarray]:
        full = self.stream.next_batch()
        b = self.stream.global_batch
        lo = b * self.host_id // self.num_hosts
        hi = b * (self.host_id + 1) // self.num_hosts
        return {k: v[lo:hi] for k, v in full.items()}
