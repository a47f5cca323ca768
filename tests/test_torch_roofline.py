"""The port's roofline counter (``repro_torch.roofline``) against known
programs and the reference's formulas.

  * ``analysis.count`` exact on a loop of 7 matmuls (2 * 64^3 * 7 FLOPs)
    and on nested loops (15 products), the counterparts of
    ``tests/test_roofline.py``'s scan tests; its HBM bytes of an
    elementwise op are the operands plus the output, and a view moves
    none.
  * ``roofline_terms`` equal to the reference's with the reference's
    ``hw`` constants set to the port's H100 datasheet figures.
  * ``model_flops_per_step`` equal to the reference's for every config
    and supported shape.
  * Each kernel wrapper's meta route (inside ``backend.meta_route()``):
    outputs of the kernel's shapes and dtypes, no launch, and its record
    equal to ``roofline.counts``; outside it a meta tensor raises.
"""
import dataclasses

import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.configs import list_archs
from repro.configs.base import supported_shapes
from repro.roofline import analysis as JRA
from repro.roofline import hw as JHW
from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import backend
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import counts
from repro_torch.roofline import hw

META = torch.device("meta")


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_matmul_loop_counts_exactly():
    n_steps, m = 7, 64

    def f(x, w):
        h = x
        for _ in range(n_steps):
            h = torch.tanh(h @ w)
        return h

    _, c = RA.count(f, _m(m, m), _m(m, m))
    assert c["flops"] == 2 * m * m * m * n_steps
    assert c["flops_aten"] == c["flops"]


def test_nested_loops_multiply():
    def f(x):
        h = x
        for _ in range(5):
            for _ in range(3):
                h = h @ h
        return h

    _, c = RA.count(f, _m(32, 32))
    assert c["flops"] == 2 * 32 ** 3 * 15


def test_bytes_are_operands_and_outputs():
    x, y = _m(128, 64), _m(128, 64)

    def f(x, y):
        z = x + y            # 3 tensors of 32 KiB
        return z.t()         # a view: no traffic

    _, c = RA.count(f, x, y)
    assert c["hbm_bytes"] == 3 * 128 * 64 * 4
    assert c["peak_live_bytes"] == 128 * 64 * 4
    assert c["collective_bytes_total"] == 0


@pytest.mark.parametrize("parsed", [
    {"flops": 989e12, "hbm_bytes": 3.35e12 / 2, "coll": 0.0},
    {"flops": 1e12, "hbm_bytes": 6.7e12, "coll": 1e9},
    {"flops": 1e9, "hbm_bytes": 1e9, "coll": 9e11},
    {"flops": 0.0, "hbm_bytes": 0.0, "coll": 0.0},
], ids=["compute", "memory", "collective", "zero"])
@pytest.mark.parametrize("n_links", [1, 4])
def test_roofline_terms_equal_the_reference(monkeypatch, parsed, n_links):
    monkeypatch.setattr(JHW, "PEAK_FLOPS_BF16", hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(JHW, "HBM_BW", hw.HBM_BW)
    monkeypatch.setattr(JHW, "ICI_BW", hw.NVLINK_BW)
    want = JRA.roofline_terms({"flops_hlo": parsed["flops"],
                               "hbm_traffic_bytes": parsed["hbm_bytes"],
                               "collective_bytes_total": parsed["coll"]},
                              n_links=n_links)
    got = RA.roofline_terms({"flops": parsed["flops"],
                             "hbm_bytes": parsed["hbm_bytes"],
                             "collective_bytes_total": parsed["coll"]},
                            n_links=n_links)
    assert got == want


def test_hw_is_the_h100_datasheet():
    assert (hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.HBM_BYTES, hw.NVLINK_BW) == \
        (989e12, 3.35e12, 80 * 10 ** 9, 450e9)


CELLS = [(a, s) for a in list_archs() for s in supported_shapes(j_config(a))]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_equal_the_reference(arch, shape):
    assert RA.model_flops_per_step(get_config(arch), SHAPES[shape]) == \
        JRA.model_flops_per_step(j_config(arch), J_SHAPES[shape])


@pytest.fixture
def meta_record():
    backend.reset_meta_counts()
    before = backend.launch_counts()
    with backend.meta_route():
        yield backend.meta_counts
    assert backend.launch_counts() == before    # nothing launched
    backend.reset_meta_counts()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [(2, 48, 48, 8, 2, 16, True, 0),
                                  (1, 40, 24, 4, 4, 8, False, 0),
                                  (2, 64, 64, 4, 1, 16, True, 16)],
                         ids=["causal", "cross", "window"])
def test_flash_meta_route(meta_record, case, dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    B, Sq, Skv, H, K, hd, causal, window = case
    q = _m(B, Sq, H, hd, dtype=dtype).requires_grad_(True)
    k = _m(B, Skv, K, hd, dtype=dtype).requires_grad_(True)
    v = _m(B, Skv, K, hd, dtype=dtype).requires_grad_(True)
    o = flash_attention(q, k, v, causal=causal, window=window)
    assert o.shape == q.shape and o.dtype == dtype and o.is_meta
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    with torch.no_grad():
        flash_attention(q, k, v, causal=causal, window=window)
    es = torch.empty((), dtype=dtype).element_size()
    fb, ff = counts.flash_fwd_work(B, Sq, Skv, H, K, hd, causal, window, es,
                                   lse=True)
    nb, nf = counts.flash_fwd_work(B, Sq, Skv, H, K, hd, causal, window, es)
    bb, bf = counts.flash_bwd_work(B, Sq, Skv, H, K, hd, causal, window, es)
    rec = meta_record()
    assert rec["flash_attention"] == {"calls": 2, "bytes": fb + nb,
                                      "flops": ff + nf, "int_ops": 0}
    assert rec["flash_attention_bwd"] == {"calls": 1, "bytes": bb,
                                          "flops": bf, "int_ops": 0}
    # the pairs the masks allow, counted against the plain mask
    from repro_torch.kernels.flash_attention.ref import attention_mask
    pairs = int(attention_mask(Sq, Skv, causal, window, "cpu").sum())
    assert nf == 4 * B * H * hd * pairs


@pytest.mark.parametrize("h0", [False, True], ids=["zero", "carried"])
def test_ssd_meta_route(meta_record, h0):
    from repro_torch.kernels.ssd import ssd_chunked
    Bsz, S, H, P, N = 2, 40, 4, 8, 16
    x = _m(Bsz, S, H, P).requires_grad_(True)
    dt = _m(Bsz, S, H).requires_grad_(True)
    A = _m(H).requires_grad_(True)
    Bm, Cm = (_m(Bsz, S, N).requires_grad_(True) for _ in range(2))
    init = _m(Bsz, H, P, N).requires_grad_(True) if h0 else None
    y, st = ssd_chunked(x, dt, A, Bm, Cm, 16, init)
    assert y.shape == x.shape and st.shape == (Bsz, H, P, N)
    ins = (x, dt, A, Bm, Cm) + ((init,) if h0 else ())
    grads = torch.autograd.grad(y.sum() + st.sum(), ins)
    assert [g.shape for g in grads] == [t.shape for t in ins]
    rec = meta_record()
    q = counts.SSD_KERNEL_CHUNK
    assert rec["ssd"] == {"calls": 1,
                          "bytes": counts.ssd_bytes(Bsz, S, H, P, N),
                          "flops": counts.ssd_flops_at(Bsz, S, H, P, N, q),
                          "int_ops": 0}
    assert rec["ssd_bwd"] == {
        "calls": 1, "bytes": counts.ssd_bwd_bytes(Bsz, S, H, P, N),
        "flops": counts.ssd_bwd_flops_at(Bsz, S, H, P, N, q), "int_ops": 0}


def test_secure_agg_meta_route(meta_record):
    from repro_torch.kernels.secure_agg import ops
    B, T, n, r = 3, 100, 16, 3
    i32 = torch.int32
    words = ops.mask_encrypt_batch_fn(_m(B, T), _m(B, dtype=i32),
                                      _m(B, dtype=i32), 1.0, 8.0,
                                      offsets=_m(B, dtype=i32))
    assert words.shape == (B, T) and words.dtype == i32
    dec = ops.unmask_decrypt_batch_fn(words, n, _m(B, dtype=i32), 1.0,
                                      offsets=_m(B, dtype=i32))
    assert dec.shape == (B, T) and dec.dtype == torch.float32
    acc = _m(B * T, dtype=i32)
    out = ops.vote_combine_fn([_m(B * T, dtype=i32) for _ in range(r)], acc)
    assert out.shape == acc.shape and out.dtype == i32
    rec = meta_record()
    for name, (nb, io, fo) in (("mask_encrypt", counts.mask_work(B, T)),
                               ("unmask_decrypt",
                                counts.unmask_work(B, T, n)),
                               ("vote_combine", counts.vote_work(r, B * T))):
        assert rec[name] == {"calls": 1, "bytes": nb, "flops": fo,
                             "int_ops": io}, name


def test_modmul_meta_route(meta_record):
    from repro_torch.kernels.modmul import ops
    rows, L, nbits = 5, 8, 33
    a = _m(rows, L, dtype=torch.int32)
    out = ops.mont_mul_op(a, a, [1] * L, 3)
    assert out.shape == (rows, L) and out.dtype == torch.int32
    out = ops.mont_exp_op(a, _m(rows, nbits, dtype=torch.int32), [1] * L, 3,
                          _m(L, dtype=torch.int32))
    assert out.shape == (rows, L)
    rec = meta_record()
    nb, io = counts.mont_mul_work(rows, L)
    assert rec["mont_mul"] == {"calls": 1, "bytes": nb, "flops": 0,
                               "int_ops": io}
    nb, io = counts.mont_exp_work(rows, L, nbits)
    assert rec["mont_exp"] == {"calls": 1, "bytes": nb, "flops": 0,
                               "int_ops": io}


def test_cpu_tensors_still_run_the_plain_version(meta_record):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(1, 8, 2, 4)
    assert torch.isfinite(flash_attention(q, q, q)).all()
    assert meta_record() == {}
    assert backend.resolve(None, q) == "torch"
    assert backend.resolve(None, _m(1)) == "meta"
    assert backend.resolve("torch", _m(1)) == "torch"


def test_meta_tensors_raise_outside_the_meta_route():
    """A meta tensor takes the meta route only inside ``meta_route()``
    (the dry run's counter); elsewhere it has no kernel."""
    with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
        backend.resolve(None, _m(1))
    assert dataclasses.is_dataclass(get_config("olmo-1b"))
