"""The work of a dense decoder's training step and of its attention
kernels, from the model's shapes: the work the model defines for those
inputs, whatever implements it.  A product counts two FLOPs a
multiply-add; recomputation (remat) is not counted."""


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask allows over S positions."""
    return S * (S + 1) // 2


def matmul_params(cfg: dict) -> int:
    """Weights that take part in a product a token: every layer's
    projections and MLP, and the output head (the tied embedding's
    table)."""
    d, H, K = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd, f = cfg["head_dim"], cfg["intermediate_size"]
    per_layer = d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * f
    return cfg["num_hidden_layers"] * per_layer + d * cfg["vocab_size"]


def attention_fwd_flops(cfg: dict, B: int, S: int) -> int:
    """One causal attention layer's forward: q k^T and p v."""
    return 4 * B * cfg["num_attention_heads"] * cfg["head_dim"] \
        * causal_pairs(S)


def train_step_flops(cfg: dict, B: int, S: int) -> int:
    """6 x params x tokens, plus causal attention's forward and its
    backward (twice the forward) in every layer."""
    return 6 * matmul_params(cfg) * B * S \
        + 3 * cfg["num_hidden_layers"] * attention_fwd_flops(cfg, B, S)


def flash_fwd_work(cfg: dict, B: int, S: int, elem: int = 2) -> tuple:
    """(bytes, FLOPs) of one causal flash forward with the row
    log-sum-exp kept for the backward: q, k, v read, o written in
    ``elem``-byte elements, the float32 log-sum-exp written."""
    H, K, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    nbytes = elem * (2 * B * S * H * hd + 2 * B * S * K * hd) + 4 * B * H * S
    return nbytes, attention_fwd_flops(cfg, B, S)


def flash_bwd_work(cfg: dict, B: int, S: int, elem: int = 2) -> tuple:
    """(bytes, FLOPs) of one causal flash backward from q, k, v, o, dO
    and the log-sum-exp: those read once, dq, dk, dv written; the
    scores again (they are not among its inputs), dP, dV, dQ and dK:
    five products over the allowed pairs."""
    H, K, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    q_side = B * S * H * hd
    kv_side = B * S * K * hd
    nbytes = elem * (3 * q_side + 2 * kv_side) + 4 * B * H * S \
        + elem * (q_side + 2 * kv_side)
    return nbytes, 10 * B * H * hd * causal_pairs(S)
