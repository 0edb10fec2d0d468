"""Deterministic synthetic LM data: ``batch_at`` is a copy of the JAX
package's numpy generator, so both packages see the same tokens, frame
embeddings (audio) and image embeddings (VLM) for a given (seed, host,
step).  Each of ``host_count`` hosts makes only its slice of the global
batch; a process may read several consecutive hosts' slices (``hosts``),
as a run restored on fewer processes does to keep the global batch."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


class SyntheticLMData:
    """Markov-ish synthetic token stream (structured enough that loss drops)."""

    def __init__(self, cfg, global_batch: int, seq_len: int, seed: int = 0,
                 host_index: int = 0, host_count: int = 1, hosts: int = 1):
        if global_batch % host_count:
            raise ValueError("global_batch must divide evenly over hosts")
        if not 0 <= host_index <= host_count - hosts:
            raise ValueError(f"hosts {host_index}..{host_index + hosts - 1} "
                             f"of {host_count}")
        self.cfg = cfg
        self.host_batch = global_batch // host_count
        self.local_batch = self.host_batch * hosts
        self.seq = seq_len
        self.seed = seed
        self.host = host_index
        self.hosts = hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """This process's batch of ``step``: its host's slice, or its hosts'
        slices concatenated along the batch."""
        parts = [self.host_batch_at(h, step)
                 for h in range(self.host, self.host + self.hosts)]
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def host_batch_at(self, host: int, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, host, step]))
        B, S, V = self.host_batch, self.seq, cfg.vocab_size
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
        if cfg.modality == "audio_embed":
            emb = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
            return {"embeds": emb, "labels": labels, "loss_mask": mask}
        if cfg.modality == "vlm":     # S counts the image prefix
            P = cfg.prefix_len
            img = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
            return {"image_embeds": img, "tokens": tokens[:, :S - P],
                    "labels": labels[:, :S - P],
                    "loss_mask": mask[:, :S - P]}
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}

    def device_batch(self, step: int, device) -> Dict[str, torch.Tensor]:
        """:meth:`batch_at` as tensors on ``device``, frame and image
        embeddings in the model dtype (as ``configs.shapes.input_specs``
        has them; the embed stage would cast them anyway)."""
        return {k: torch.from_numpy(v).to(
            device, self.cfg.dtype if k in ("embeds", "image_embeds")
            else None) for k, v in self.batch_at(step).items()}


def sequence_shape(batch: Dict[str, Any]) -> Tuple[int, int]:
    """(B, S) of the sequence a batch (arrays or tensors) runs through the
    model: the tokens, the frame embeddings of an audio model, or a VLM's
    image prefix and tokens together."""
    x = batch["embeds"] if "embeds" in batch else batch["tokens"]
    B, S = x.shape[:2]
    if "image_embeds" in batch:
        S += batch["image_embeds"].shape[1]
    return int(B), int(S)
