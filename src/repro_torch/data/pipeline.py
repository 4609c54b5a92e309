"""Step-indexed synthetic token pipeline (stateless -> replay-deterministic).

A copy of the JAX package's ``data/pipeline.py`` (numpy only).  Every batch
is a pure function of (seed, step), so failure recovery just resumes at the
checkpointed step — no reader state to persist, no data loss on restart,
and stragglers can re-fetch any shard idempotently."""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 frontend: str = "none", frontend_tokens: int = 0, d_model: int = 0,
                 encdec: bool = False, decoder_len: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.frontend, self.ft, self.d = frontend, frontend_tokens, d_model
        self.encdec, self.dec_len = encdec, decoder_len

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        if self.encdec:
            frames = rng.standard_normal((self.batch, self.seq, self.d)).astype(np.float32)
            toks = rng.integers(0, self.vocab, (self.batch, self.dec_len + 1))
            return dict(frames=frames, tokens=toks[:, :-1].astype(np.int32),
                        labels=toks[:, 1:].astype(np.int32))
        n_text = self.seq - self.ft
        toks = rng.integers(0, self.vocab, (self.batch, n_text + 1))
        out = dict(tokens=toks[:, :-1].astype(np.int32),
                   labels=toks[:, 1:].astype(np.int32))
        if self.frontend == "vision":
            out["prefix_embeds"] = rng.standard_normal(
                (self.batch, self.ft, self.d)).astype(np.float32)
        return out
