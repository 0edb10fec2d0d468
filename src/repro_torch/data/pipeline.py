"""Deterministic synthetic LM data: ``batch_at`` is a copy of the JAX
package's numpy generator, so both packages see the same tokens for a given
(seed, host, step)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class SyntheticLMData:
    """Markov-ish synthetic token stream (structured enough that loss drops)."""

    def __init__(self, cfg, global_batch: int, seq_len: int, seed: int = 0,
                 host_index: int = 0, host_count: int = 1):
        if global_batch % host_count:
            raise ValueError("global_batch must divide evenly over hosts")
        self.cfg = cfg
        self.local_batch = global_batch // host_count
        self.seq = seq_len
        self.seed = seed
        self.host = host_index

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host, step]))
        B, S, V = self.local_batch, self.seq, cfg.vocab_size
        # tokens with local structure: next token = (tok*a + b) % V w/ noise
        a = rng.integers(2, 7)
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, S)) < 0.1
        rand = rng.integers(0, V, (B, S))
        for t in range(S):
            nxt = (toks[:, t] * a + 1) % V
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        mask = np.ones((B, S), np.float32)
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}

    def device_batch(self, step: int, device) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.batch_at(step).items()}
