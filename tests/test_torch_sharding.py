"""The port's sharding rules and shape-only stand-ins against the
reference's, with no process group and no device.

  * ``param_specs`` / ``opt_specs`` / ``batch_specs`` leaf for leaf equal
    to ``repro.launch.sharding``'s for all ten full configs on (16, 16),
    (2, 16, 16), (1, 2) and (2, 2) meshes (the reference's rules read only
    the mesh's axis names and sizes, so a ``jax.sharding.AbstractMesh``
    and the port's ``sharding.AbstractMesh`` serve); a unit leaf of the
    port has no stacked units dimension, so its spec is the reference's
    after that dimension's ``None``.
  * ``cache_specs`` leaf for leaf equal to the reference's for every
    decoder config at decode_32k and long_500k on (16, 16) and (2, 16,
    16): the K / V sequence over ``"model"``, or over ``("data",
    "model")`` where the batch does not split; the Mamba2 states on
    their heads and channels.
  * ``input_specs`` / ``abstract_params`` / ``abstract_opt_state`` /
    ``abstract_cache``: shapes and dtypes equal to the reference's
    ``eval_shape`` in all 32 cells of ``supported_shapes``.
  * ``unshard_tree(shard_tree(x))`` is ``x`` for every smoke config on
    (1, 2), (2, 2) and (1, 4) meshes and with fewer KV heads than TP
    ranks; the slices have the per-rank widths; a TP extent that does not
    split a config raises ``ConfigError`` naming the counts.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

from repro.configs import get_config, get_smoke_config, list_archs
from repro.configs.base import SHAPES, supported_shapes
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.optim import adamw as JA
from repro_torch.configs import get_config as p_config
from repro_torch.configs import get_smoke_config as p_smoke
from repro_torch.convert import opt_config_from_fields
from repro_torch.core.engine import tree_flatten
from repro_torch.core.schedules import ConfigError
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import model as PM

ARCHS = list(list_archs())
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
CELLS = [(a, s) for a in ARCHS for s in supported_shapes(get_config(a))]


def _spec_leaves(tree) -> list:
    """A reference spec tree's PartitionSpecs as tuples, in its flatten
    order, with their key paths."""
    return [(path, tuple(spec)) for path, spec in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))]


def _ref_keys(path) -> tuple:
    return tuple(k.key for k in path)


def _port_by_ref(tree, specs: bool = False) -> dict:
    """The port's leaves (tensors, or spec tuples) keyed by the
    reference's key path: a unit leaf under ("units", *rest) as the list
    of its n_units values."""
    out: dict = {}
    for path, leaf in SH._leaves_with_paths(tree, specs=specs):
        if path and path[0] == "units":
            out.setdefault(("units",) + path[2:], []).append(leaf)
        else:
            out[path] = leaf
    return out


@pytest.fixture(scope="module")
def abstract():
    """The reference's abstract params of every full config, once."""
    return {a: JST.abstract_params(get_config(a)) for a in ARCHS}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(abstract, arch, mesh):
    shape, axes = MESHES[mesh]
    jmesh, pmesh = JMesh(shape, axes), SH.AbstractMesh(shape, axes)
    jcfg, pcfg = get_config(arch), p_config(arch)
    want = _spec_leaves(JSH.param_specs(jcfg, abstract[arch], jmesh))
    got = _port_by_ref(SH.param_specs(pcfg, ST.abstract_params(pcfg),
                                      pmesh), specs=True)
    assert len(got) == len(want)
    for path, spec in want:
        keys = _ref_keys(path)
        if keys[0] == "units":
            assert spec[0] is None, keys
            assert len(got[keys]) == pcfg.n_units
            for s in got[keys]:
                assert s == spec[1:], (keys, s, spec)
        else:
            assert got[keys] == spec, (keys, got[keys], spec)
    # the optimizer's moments mirror the parameters; its step replicated
    ospecs = SH.opt_specs(pcfg, None, {"x": ("model",)}, pmesh)
    jo = JSH.opt_specs(jcfg, None, {"x": jax.sharding.PartitionSpec(
        "model")}, jmesh)
    assert ospecs == {k: ({"x": tuple(v["x"])} if k != "step"
                          else tuple(v)) for k, v in jo.items()}
    for name in supported_shapes(jcfg):
        jb = JSH.batch_specs(jcfg, SHAPES[name], jmesh)
        pb = SH.batch_specs(pcfg, SHAPES[name], pmesh)
        assert pb == {k: tuple(v) for k, v in jb.items()}, name
    for gb in (1, 2, 3, 4, 32):
        cell = dataclasses.replace(SHAPES["decode_32k"], global_batch=gb)
        jb = JSH.batch_specs(jcfg, cell, jmesh)
        assert SH.batch_specs(pcfg, cell, pmesh) == \
            {k: tuple(v) for k, v in jb.items()}, gb


DECODERS = [a for a in ARCHS if get_config(a).decoder]


@pytest.mark.parametrize("arch", DECODERS)
def test_cache_specs_where_the_port_holds_them(arch):
    """The port's ``cache_specs`` leaf for leaf the reference's, at
    decode_32k and, where the config has it, long_500k (batch 1: the
    K / V sequence over ("data", "model")), on (16, 16) and (2, 16,
    16)."""
    jcfg, pcfg = get_config(arch), p_config(arch)
    cells = [c for c in ("decode_32k", "long_500k")
             if c in supported_shapes(jcfg)]
    assert "decode_32k" in cells
    for cell in cells:
        shape = SHAPES[cell]
        jcache = JST.abstract_cache(jcfg, shape)
        cache = ST.abstract_cache(pcfg, shape)
        for mesh in ("16x16", "2x16x16"):
            dims, axes = MESHES[mesh]
            want = dict((_ref_keys(p), s) for p, s in _spec_leaves(
                JSH.cache_specs(jcfg, jcache, shape, JMesh(dims, axes))))
            got = SH._leaves_with_paths(SH.cache_specs(
                pcfg, cache, shape, SH.AbstractMesh(dims, axes)),
                specs=True)
            assert len(got) == len(want) * pcfg.n_units
            for path, spec in got:
                ref = want[path[1:]]
                assert ref[0] is None, (path, ref)
                assert spec == ref[1:], (cell, mesh, path, spec, ref)


def _same(got, want, where) -> None:
    assert tuple(got.shape) == tuple(want.shape), (where, got.shape,
                                                    want.shape)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), \
        (where, got.dtype, want.dtype)


def _same_tree(got_tree, want_tree, n_units: int) -> None:
    want = {_ref_keys(p): leaf for p, leaf in
            jax.tree_util.tree_leaves_with_path(want_tree)}
    got = _port_by_ref(got_tree)
    assert set(got) == set(want)
    for keys, leaf in want.items():
        if keys[0] == "units":
            assert len(got[keys]) == n_units == leaf.shape[0], keys
            for g in got[keys]:
                _same(g, jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype),
                      keys)
        else:
            _same(got[keys], leaf, keys)


@pytest.mark.parametrize("arch,cell", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_abstract_shapes_equal_the_reference(abstract, arch, cell):
    jcfg, pcfg = get_config(arch), p_config(arch)
    shape = SHAPES[cell]
    want = JST.input_specs(jcfg, shape)
    got = ST.input_specs(pcfg, shape)
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "meta"
        _same(got[k], want[k], k)
    cache = ST.abstract_cache(pcfg, shape)
    assert all(t.device.type == "meta" for t in tree_flatten(cache)[0])
    _same_tree({"units": cache}, {"units": JST.abstract_cache(jcfg, shape)},
               pcfg.n_units)
    if cell == supported_shapes(jcfg)[0]:       # once a config
        _same_tree(ST.abstract_params(pcfg), abstract[arch], pcfg.n_units)
        jopt = JA.OptConfig(state_dtype=jcfg.opt_state_dtype)
        popt = opt_config_from_fields(dataclasses.asdict(jopt))
        want_opt = JST.abstract_opt_state(jcfg, jopt)
        got_opt = ST.abstract_opt_state(pcfg, popt)
        for k in ("m", "v"):
            _same_tree(got_opt[k], want_opt[k], pcfg.n_units)
        _same(got_opt["step"], want_opt["step"], "step")


SHARD_MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}


@pytest.mark.parametrize("mesh", list(SHARD_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_unshard_inverts_shard(arch, mesh):
    cfg = p_smoke(arch)
    data, model = SHARD_MESHES[mesh]
    if model == 4:
        # the smoke widths split four ways: two KV heads, so each is held
        # by two ranks
        cfg = dataclasses.replace(cfg, n_heads=8)
    am = SH.AbstractMesh((data, model), ("data", "model"))
    full = PM.init_params(cfg, torch.Generator().manual_seed(0))
    slices = [SH.shard_tree(cfg, full, am, rank=r) for r in range(am.size)]
    back = SH.unshard_tree(cfg, slices, am)
    for a, b in zip(tree_flatten(back)[0], tree_flatten(full)[0]):
        assert torch.equal(a, b)
    # the per-rank widths
    for r, sl in enumerate(slices):
        m = am.coord("model", r)
        lo, n_kv = PM.L.kv_block(cfg, model, m)
        for unit, full_unit in zip(sl["units"], full["units"]):
            for name, lp in unit.items():
                mixer = lp["mixer"]
                if "wq" in mixer:
                    H = cfg.n_heads // model
                    assert mixer["wq"].shape[1] == H * cfg.hd
                    assert mixer["wo"].shape[0] == H * cfg.hd
                    assert mixer["wk"].shape[1] == n_kv * cfg.hd
                    want = full_unit[name]["mixer"]["wk"][
                        :, lo * cfg.hd:(lo + n_kv) * cfg.hd]
                    assert torch.equal(mixer["wk"], want)
                if "in_x" in mixer:
                    d_in = cfg.ssm.expand * cfg.d_model
                    assert mixer["in_x"].shape[1] == d_in // model
                    assert mixer["out_proj"].shape[0] == d_in // model
                    assert torch.equal(mixer["in_B"],
                                       full_unit[name]["mixer"]["in_B"])
        if "embed" in sl:
            assert sl["embed"].shape[0] == PM.padded_vocab(cfg) // model


def test_kv_heads_fewer_than_tp_ranks_at_full_width():
    """qwen3-moe's 4 KV heads at tp 8 (a KV head on two ranks), on meta
    tensors: each rank's wk holds the one head its 8 query heads read."""
    cfg = p_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, n_units=1)
    am = SH.AbstractMesh((1, 8), ("data", "model"))
    full = ST.abstract_params(cfg)
    for r in range(8):
        mixer = SH.shard_tree(cfg, full, am, rank=r)["units"][0][
            "layer0"]["mixer"]
        assert mixer["wq"].shape[1] == 8 * cfg.hd
        assert mixer["wk"].shape[1] == cfg.hd
        assert PM.L.kv_block(cfg, 8, r) == (r // 2, 1)


@pytest.mark.parametrize("arch,tp,names", [
    ("llama4-maverick-400b-a17b", 16, None),
    ("qwen3-1.7b", 3, "16 query heads"),
    ("mamba2-370m", 3, "32 SSD heads"),
], ids=["llama4-tp16", "qwen3-tp3", "mamba2-tp3"])
def test_tp_that_does_not_split_raises(arch, tp, names):
    """A TP extent that does not split a config raises, except for query
    heads whose KV heads split: llama4-maverick's 40 heads at TP 16 are
    padded (groups of 5 to 6), on meta tensors each rank's ``wq`` is
    5,120 x 384 (3 heads), its ``wk`` one KV head, its ``wo`` 384 x
    5,120, and the unpadded shapes come back from ``unshard_tree``."""
    cfg = p_config(arch)
    am = SH.AbstractMesh((1, tp), ("data", "model"))
    one = dataclasses.replace(cfg, n_units=1)
    if names is None:
        SH.check_tp(cfg, tp)
        ST._check_mesh(cfg, am)
        assert SH.pad_heads(cfg, tp) == 8
        full = ST.abstract_params(one)
        slices = [SH.shard_tree(one, full, am, rank=r) for r in range(tp)]
        for r, sl in enumerate(slices):
            mixer = sl["units"][0]["layer0"]["mixer"]
            assert tuple(mixer["wq"].shape) == (cfg.d_model, 3 * cfg.hd)
            assert tuple(mixer["wk"].shape) == (cfg.d_model, cfg.hd)
            assert tuple(mixer["wo"].shape) == (3 * cfg.hd, cfg.d_model)
            assert PM.L.kv_block(cfg, tp, r) == (r // 2, 1)
        back = SH.unshard_tree(one, slices, am)
        for a, b in zip(tree_flatten(back)[0], tree_flatten(full)[0]):
            assert a.shape == b.shape
        return
    with pytest.raises(ConfigError, match=names):
        SH.check_tp(cfg, tp)
    with pytest.raises(ConfigError, match=f"the {tp} ranks of 'model'"):
        SH.shard_tree(cfg, ST.abstract_params(one), am, rank=0)
    with pytest.raises(ConfigError):
        ST._check_mesh(cfg, am)
