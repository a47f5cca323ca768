"""Token batches of a training mix: ``count`` distinct batches of
``batch`` rows of ``seq_len`` tokens drawn uniformly from the
vocabulary, each row's labels its next tokens."""
import torch

from chipbench.traffic import generator


def batches(seed: int, count: int, batch: int, seq_len: int, vocab: int,
            device) -> list:
    g = generator(seed, 2, device)
    seqs = torch.randint(0, vocab, (count, batch, seq_len + 1), generator=g,
                         device=device, dtype=torch.int64).to(torch.int32)
    return [{"tokens": s[:, :-1].contiguous(), "labels": s[:, 1:].contiguous()}
            for s in seqs]
