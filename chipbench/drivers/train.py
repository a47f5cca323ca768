"""Back-to-back training steps of a dense decoder through the step the
port's ``launch/steps.py`` builds: ``build_secure_train_step`` (the
gradient sync through the paper's aggregation, one party a chip) or
``build_train_step``.

Set-up builds the step, hands it the benchmark's seeded weights in the
program's tree and its optimizer state, and drives that one object
through its first three steps on distinct batches (every shape the
window uses), reading each step's loss, each weight's first gradient as
the optimizer took it (its first moment after one step) and each
weight's change over the three.  The window then runs the same object on
further batches, each step ending with its loss read back.  After the
window the plain reference trains the same weights on the same first
batches and the readings are compared (``chipbench.compare``).  A
secure step is held besides to its sync: over every step, set-up's and
the window's, the mask and the unmask kernel each launch once a chunk
of the gradients (``sync_launch_gap``), since at one party the sync's
fixed-point round trip changes a gradient far below the bf16 noise the
readings allow.
"""
import contextlib
import math

import torch
from torch.profiler import record_function

from chipbench import compare, harness
from chipbench.reference import qwen3 as ref
from chipbench.traffic import tokens, weights

SETUP_STEPS = 3
# the program's leaves of a layer (path below the unit's "layer0") by the
# benchmark's weight names
LAYER_MAP = {("norm1", "scale"): "input_layernorm",
             ("mixer", "wq"): "q_proj", ("mixer", "wk"): "k_proj",
             ("mixer", "wv"): "v_proj", ("mixer", "wo"): "o_proj",
             ("mixer", "q_norm"): "q_norm", ("mixer", "k_norm"): "k_norm",
             ("norm2", "scale"): "post_attention_layernorm",
             ("mlp", "w_gate"): "gate_proj", ("mlp", "w_up"): "up_proj",
             ("mlp", "w_down"): "down_proj"}


def model_config(cell: harness.Cell):
    from repro_torch.configs.base import LayerSpec, ModelConfig
    c, tr = cell.config, cell.config["training"]
    if not c["tie_word_embeddings"]:
        raise ValueError("the driver maps a tied-embedding decoder only")
    return ModelConfig(
        name=c["name"], family="dense", d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        pattern=(LayerSpec("attn", "dense"),),
        n_units=c["num_hidden_layers"], qk_norm=True, tie_embeddings=True,
        rope_theta=float(c["rope_theta"]), dp_mode="replicated",
        dtype=tr["compute_dtype"], param_dtype="float32",
        opt_state_dtype=tr["optimizer"]["state_dtype"], remat=tr["remat"])


def opt_config(cell: harness.Cell):
    from repro_torch.optim import adamw
    o = cell.config["training"]["optimizer"]
    return adamw.OptConfig(lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"],
                           weight_decay=o["weight_decay"],
                           grad_clip=o["grad_clip"],
                           warmup_steps=o["warmup_steps"],
                           total_steps=o["total_steps"],
                           min_lr_frac=o["min_lr_frac"],
                           state_dtype=o["state_dtype"])


def sync_config(cell: harness.Cell):
    from repro_torch.core.plan import AggConfig
    s = cell.config["training"]["sync"]
    return AggConfig(n_nodes=s["committee_nodes"],
                     cluster_size=s["cluster_size"],
                     redundancy=s["redundancy"], masking=s["masking"],
                     clip=s["clip"], guard_bits=s["guard_bits"],
                     chunk_elems=s["chunk_elems"],
                     kernel_impl=cell.impl).derive(n_nodes=s["parties"])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def named_leaves(tree, vocab: int) -> dict:
    """The program's tree (parameters, or a moment of the same shape) by
    the benchmark's weight names; the embedding's rows of the published
    vocabulary (the program pads its table)."""
    out = {}
    for path, t in _leaves(tree):
        if path == ("embed",):
            out["embed_tokens"] = t[:vocab]
        elif path == ("final_norm", "scale"):
            out["norm"] = t
        elif path[0] == "units" and path[2] == "layer0":
            out[f"layers.{path[1]}.{LAYER_MAP[path[3:]]}"] = t
        else:
            raise KeyError(f"the program has a leaf {path} the benchmark "
                           "does not map")
    return out


def program_params(cfg, c: dict, seed: int, dev) -> dict:
    """The benchmark's weights in the program's tree, checked leaf for
    leaf against the shapes and dtypes the program's own init gives."""
    from repro_torch.models import model as M
    abstract = M.init_params(cfg, torch.device("meta"))
    Vp, d = abstract["embed"].shape
    table = torch.zeros((Vp, d), device=dev)
    table[:c["vocab_size"]] = weights.embed(c, seed, dev)
    params = {"embed": table,
              "final_norm": {"scale": torch.ones((d,), device=dev)},
              "units": []}
    for i in range(c["num_hidden_layers"]):
        w = weights.layer(c, seed, i, dev)
        unit: dict = {}
        for (part, leaf), name in LAYER_MAP.items():
            unit.setdefault(part, {})[leaf] = w[name]
        params["units"].append({"layer0": unit})
    want = {p: (tuple(t.shape), t.dtype) for p, t in _leaves(abstract)}
    got = {p: (tuple(t.shape), t.dtype) for p, t in _leaves(params)}
    if want != got:
        raise ValueError("the program's parameter tree differs from the "
                         f"benchmark's: {sorted(set(want) ^ set(got))[:4]}")
    return params


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))


def change_norms(c: dict, seed: int, params_named: dict, dev) -> dict:
    """Each weight's norm of its change from the seed's weights, made
    again a group at a time (no copy of the whole model is kept)."""
    out = {"embed_tokens": _norm(params_named["embed_tokens"]
                                 - weights.embed(c, seed, dev)),
           "norm": _norm(params_named["norm"] - 1.0)}
    for i in range(c["num_hidden_layers"]):
        for k, t in weights.layer(c, seed, i, dev).items():
            out[f"layers.{i}.{k}"] = _norm(params_named[f"layers.{i}.{k}"]
                                           - t)
    return out


def sync_launch_gap(before: dict, after: dict, chunks: int,
                    steps: int) -> int:
    """How far the mask and unmask launches over ``steps`` steps lie from
    one of each a chunk a step."""
    return sum(abs(after[k] - before[k] - chunks * steps)
               for k in ("mask_encrypt", "unmask_decrypt"))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(cell: harness.Cell, fault=None) -> harness.Outcome:
    """``fault`` (tests only) wraps the step to break it."""
    from repro_torch.kernels import backend
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import single_rank_mesh
    from repro_torch.optim import adamw
    from repro_torch.configs.base import ShapeConfig
    dev = torch.device(cell.device)
    c, t = cell.config, cell.traffic
    B, S = t["batch"], t["seq_len"]
    secure = t["sync"] == "secure"
    cfg, opt = model_config(cell), opt_config(cell)
    shape = ShapeConfig(cell.name, S, B, "train")
    batches = tokens.batches(cell.seed, t["batches"], B, S,
                             c["vocab_size"], dev)
    failed = 0
    with (single_rank_mesh() if secure else contextlib.nullcontext()) as mesh:
        if secure:
            step, opt = ST.build_secure_train_step(
                cfg, mesh, sync_config(cell), opt_cfg=opt, shape=shape)
        else:
            step, opt = ST.build_train_step(cfg, opt_cfg=opt, shape=shape)
        if fault is not None:
            step = fault(step)
        params = program_params(cfg, c, cell.seed, dev)
        chunks = -(-sum(x.numel() for _, x in _leaves(params))
                   // c["training"]["sync"]["chunk_elems"])
        state = adamw.init_opt_state(opt, params)
        launched = backend.launch_counts()
        prog = {"loss": []}
        for k in range(SETUP_STEPS):
            params, state, met = step(params, state, batches[k])
            prog["loss"].append(float(met["loss"]))
            if k == 0:
                m1 = named_leaves(state["m"], c["vocab_size"])
                prog["grad"] = {n: _norm(x) / (1 - opt.betas[0])
                                for n, x in m1.items()}
                del m1
        prog["change"] = change_norms(
            c, cell.seed, named_leaves(params, c["vocab_size"]), dev)
        _sync(dev)

        win = harness.Window(cell)
        win.start()
        k = SETUP_STEPS
        while True:
            with record_function("bench.step"):
                params, state, met = step(params, state,
                                          batches[k % len(batches)])
                loss = float(met["loss"])
            failed += not math.isfinite(loss)
            k += 1
            if not win.tick():
                break
        win.stop()
        steps = k - SETUP_STEPS
        prog["sync_launch_gap"] = sync_launch_gap(
            launched, backend.launch_counts(), chunks if secure else 0, k)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        del params, state, met, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want = ref.train_readings(c, cell.seed, batches[:SETUP_STEPS], dev,
                              secure=secure, steps=SETUP_STEPS)
    g = compare.gaps(prog, want)
    g["sync_launch_gap"] = prog["sync_launch_gap"]
    e2e = {cell.workload["tokens_metric"]: B * S * steps / win.seconds,
           "setup_s": win.t0 - cell.t_start}
    checks = [(name, g[name], cell.limits[name])
              for name in ("loss_gap", "grad_gap", "change_gap",
                           "sync_launch_gap")
              if name in cell.limits]
    return harness.Outcome(attempted=steps, failed=failed, e2e=e2e,
                           checks=checks, memory_peak_bytes=peak, window=win,
                           details={"program": prog, "reference": want,
                                    "gaps": g})
