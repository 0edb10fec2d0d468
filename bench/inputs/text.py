"""Token batches: uniform random token ids, labels the next token, every
position in the loss."""

import torch

from bench.seeds import derive


def make_batch(conf, batch, seq, seed, step, device):
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "batch", step))
    toks = torch.randint(0, conf["vocab_size"], (batch, seq + 1),
                         generator=g, device=device)
    return {"tokens": toks[:, :-1].to(torch.int32).contiguous(),
            "labels": toks[:, 1:].to(torch.int32).contiguous(),
            "loss_mask": torch.ones((batch, seq), dtype=torch.float32,
                                    device=device)}
