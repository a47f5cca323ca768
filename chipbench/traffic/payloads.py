"""Node payloads of an allreduce: ``sets`` distinct (n, T) float32
batches, each node's row normal with the mix's ``payload_std`` (values
beyond the protocol's clip are clipped by it, as a deployment's
outliers are)."""
import torch

from chipbench.traffic import generator


def node_payloads(seed: int, n: int, T: int, traffic: dict, device
                  ) -> list:
    g = generator(seed, 1, device)
    std = float(traffic["payload_std"])
    return [torch.randn((n, T), generator=g, device=device) * std
            for _ in range(int(traffic["payload_sets"]))]
