"""Seeded weights of a dense decoder (the Qwen3 layout), by name, made on
the device in float32: normal with the config's ``initializer_range``
for every matrix, ones for every norm's scale.  Each group (the
embedding, each layer) has a stream of its own, so any group can be made
again alone.  Matrices are stored as they multiply a row vector: x @ W.

Names: ``embed_tokens`` (V, d), ``norm`` (d,), and for layer i
``layers.i.<leaf>`` with leaves ``input_layernorm`` (d,), ``q_proj``
(d, H hd), ``k_proj`` / ``v_proj`` (d, K hd), ``o_proj`` (H hd, d),
``q_norm`` / ``k_norm`` (hd,), ``post_attention_layernorm`` (d,),
``gate_proj`` / ``up_proj`` (d, f), ``down_proj`` (f, d).
"""
import torch

from chipbench.traffic import generator

LAYER_MATRICES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                  "up_proj", "down_proj")


def layer_shapes(cfg: dict) -> dict:
    d, H, K = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd, f = cfg["head_dim"], cfg["intermediate_size"]
    return {"q_proj": (d, H * hd), "k_proj": (d, K * hd),
            "v_proj": (d, K * hd), "o_proj": (H * hd, d),
            "gate_proj": (d, f), "up_proj": (d, f), "down_proj": (f, d)}


def embed(cfg: dict, seed: int, device) -> torch.Tensor:
    g = generator(seed, 100, device)
    std = float(cfg["initializer_range"])
    return torch.randn((cfg["vocab_size"], cfg["hidden_size"]), generator=g,
                       device=device) * std


def layer(cfg: dict, seed: int, i: int, device) -> dict:
    """Layer i's weights by leaf name: its matrices from one draw."""
    shapes = layer_shapes(cfg)
    sizes = [shapes[k][0] * shapes[k][1] for k in LAYER_MATRICES]
    g = generator(seed, 101 + i, device)
    flat = torch.randn((sum(sizes),), generator=g, device=device)
    flat.mul_(float(cfg["initializer_range"]))
    out = {k: t.view(shapes[k]).clone()
           for k, t in zip(LAYER_MATRICES, flat.split(sizes))}
    del flat
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    for k, n in (("input_layernorm", d), ("post_attention_layernorm", d),
                 ("q_norm", hd), ("k_norm", hd)):
        out[k] = torch.ones((n,), device=device)
    return out


def named(cfg: dict, seed: int, device) -> dict:
    """Every weight by its full name."""
    out = {"embed_tokens": embed(cfg, seed, device),
           "norm": torch.ones((cfg["hidden_size"],), device=device)}
    for i in range(cfg["num_hidden_layers"]):
        for k, t in layer(cfg, seed, i, device).items():
            out[f"layers.{i}.{k}"] = t
    return out
