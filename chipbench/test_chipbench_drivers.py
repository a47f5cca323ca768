"""Each driver and reader at a tiny size on the CPU, the references
against the port, and the faults and the control that ``correct`` has to
catch."""
import copy
import time

import pytest
import torch

from chipbench import compare, harness
from chipbench.counts import secagg as secagg_counts
from chipbench.reference import qwen3, secagg
from chipbench.traffic import payloads, tokens

SEED = 2_147_483_659          # more than 32 signed bits hold


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.fixture(autouse=True)
def launches_on_the_cpu(monkeypatch):
    """The secure-agg kernels' plain versions count a launch of their
    kernel, as the card's wrappers do, so the launch checks read on the
    CPU what they read on the card."""
    from repro_torch.kernels import backend
    from repro_torch.kernels.secure_agg import ref as R
    for name, kernel in (("mask_encrypt_batch_ref", backend.MASK),
                         ("unmask_decrypt_batch_ref", backend.UNMASK),
                         ("vote_combine_ref", backend.VOTE)):
        monkeypatch.setattr(R, name, _counted(getattr(R, name), kernel))


def _counted(fn, kernel):
    def f(*a, **kw):
        kernel.launches += 1
        return fn(*a, **kw)
    f.__wrapped__ = fn
    return f


def tiny_cell(bench, name: str, trace: bool = False, **cfg_kw) -> harness.Cell:
    """The cell as committed, cut to a size the CPU runs in a second: the
    same driver, traffic kind and limits."""
    entry, config, workload = harness.find_cell(bench, name)
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    if "protocol" in config:
        p = config["protocol"]
        p["n_nodes"] = 8
        config["payload"]["elems_per_node"] = 4096
        plan = workload["launches_per_call"]
        if plan["vote_combine"]:
            plan["vote_combine"] = secagg_counts.voted_rounds(
                p["schedule"], p["n_nodes"] // p["cluster_size"])
    else:
        config.update(hidden_size=128, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=64,
                      intermediate_size=256, vocab_size=512,
                      num_hidden_layers=2)
        workload["traffic"].update(batch=2, seq_len=32, batches=8)
    for k, v in cfg_kw.items():
        config["training"][k] = v
    return harness.Cell(name=name, entry=entry, config=config,
                        workload=workload, seed=SEED, seconds=0.05,
                        trace=trace, device="cpu",
                        t_start=time.perf_counter(), impl="torch")


def driver(cell):
    return harness.load_module(
        harness.HERE / "drivers" / f"{cell.workload['driver']}.py",
        "chipbench_driver_test")


def _cells(kind: str) -> list:
    """The committed cells whose traffic is of ``kind``."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    return [w["name"] for w in bench["workloads"]
            if harness.find_cell(bench, w["name"])[2]["driver"] == kind]


ALLREDUCE = _cells("allreduce")
TRAIN = _cells("train")


@pytest.mark.parametrize("name", ALLREDUCE + TRAIN)
def test_driver_runs_correct_at_a_tiny_size(bench, name):
    cell = tiny_cell(bench, name)
    r = harness.run_cell(bench, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    want = {m["name"] for m in harness.metrics_for(bench, name, False)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == set(cell.limits)


@pytest.mark.parametrize("name", ALLREDUCE + TRAIN)
def test_device_readers_refuse_a_run_off_the_card(bench, name):
    with pytest.raises(harness.NoCard):
        harness.run_cell(bench, tiny_cell(bench, name, trace=True))


@pytest.mark.parametrize("name", ALLREDUCE + TRAIN)
def test_readers_on_a_trace_that_stands_in_for_the_card(bench, name):
    """Every per-layer reader of the cell gives a number from a trace of
    the cell's kernels (the cell marked as on the card)."""
    cell = tiny_cell(bench, name)
    cell.device = "cuda"
    cell.config = harness.find_cell(bench, name)[1]
    cell.workload = harness.find_cell(bench, name)[2]
    ops, spans, t = [], [], 0.0
    kernels = (["mask_kernel", "vote_kernel", "unmask_kernel", "gather"]
               if name in ALLREDUCE else
               ["flash_wgmma_kernel", "fa_delta_kernel",
                "fa_dkdv_wgmma_kernel", "fa_dq_wgmma_kernel", "nvjet_gemm"])
    for i in range(4):
        spans.append(("bench.call" if name in ALLREDUCE else "bench.step",
                      t, t + 0.01))
        spans.append(("secure_sync", t + 0.001, t + 0.002))
        for k in kernels:
            ops.append((k, "kernel", t, 0.1))
            t += 0.12
    tr = harness.Trace(ops=ops, spans=spans, window_s=t, iters=4, cell=cell)
    got = harness.read_per_layer(bench, cell, tr)
    layer = {m["name"] for m in harness.metrics_for(bench, name, True)}
    assert set(got) == layer
    assert all(v["value"] > 0 for v in got.values())


def test_secure_sum_reference_equals_the_port(bench):
    from repro_torch.core.masking import MaskConfig, reference_aggregate
    xs = payloads.node_payloads(SEED, 8, 5000, {"payload_std": 0.7,
                                                "payload_sets": 1},
                                "cpu")[0]
    assert (xs.abs() > 1.0).any()                 # the clip is exercised
    want = reference_aggregate(MaskConfig(n_nodes=8, clip=1.0,
                                          guard_bits=2), xs)
    assert torch.equal(secagg.exact_sum(xs, 1.0, 2), want)
    assert not torch.equal(secagg.float_sum(xs, 1.0, 2), want)


@pytest.mark.parametrize("name", TRAIN)
def test_training_reference_follows_the_port_in_float32(bench, name):
    """With the program's products in float32 the reference and the port
    agree to float32 rounding: the reference is the same training."""
    cell = tiny_cell(bench, name, compute_dtype="float32")
    g = driver(cell).run(cell).details["gaps"]
    assert g["loss_gap"] < 1e-6
    assert g["grad_gap"] < 1e-4
    assert g["change_gap"] < 1e-3
    assert g["left_out"] == []


# faults planted under the timed path: each has to turn ``correct`` false

def _unchanged_allreduce(call):
    return lambda xs: xs.clone()


def _half_the_parties(call):
    def f(xs):
        h = xs.shape[0] // 2
        return 2 * call(torch.cat([xs[:h], torch.zeros_like(xs[h:])]))
    return f


def _one_answer_altered(call):
    def f(xs):
        out = call(xs)
        out.view(-1)[7] += 2.0 ** -10
        return out
    return f


@pytest.mark.parametrize("name", ALLREDUCE)
@pytest.mark.parametrize("fault", [_unchanged_allreduce, _half_the_parties,
                                   _one_answer_altered])
def test_allreduce_faults_are_caught(bench, name, fault):
    cell = tiny_cell(bench, name)
    assert not driver(cell).run(cell, fault=fault).correct


# faults inside the program, planted in its kernels' plain versions: the
# sum stays exact on honest traffic, so only the guarantees' checks see
# them

def _vote_takes_the_first_copy(monkeypatch):
    from repro_torch.kernels import backend
    from repro_torch.kernels.secure_agg import ref as R

    def vote(copies, acc):
        backend.VOTE.launches += 1
        return acc + copies[0]
    monkeypatch.setattr(R, "vote_combine_ref", vote)


def _digests_ignored(monkeypatch):
    from repro_torch.core import byzantine, engine

    def take_the_payload(payload, dg_copies, base, backup=None, n_words=16):
        return byzantine.add32(base, payload)
    monkeypatch.setattr(engine, "digest_vote_combine", take_the_payload)


def _masking_skipped(monkeypatch):
    """Quantize and dequantize only: no pad added, none taken off."""
    from repro_torch.kernels.secure_agg import ref as R
    mask = R.mask_encrypt_batch_ref.__wrapped__      # launches nothing
    unmask = R.unmask_decrypt_batch_ref.__wrapped__

    def quantize(x, node_ids, seeds, scale, clip, mode="mask", **kw):
        return mask(x, node_ids, seeds, scale, clip, mode="quantize", **kw)

    def dequantize(agg, n_nodes, seeds, scale, mode="mask", **kw):
        return unmask(agg, n_nodes, seeds, scale, mode="dequantize", **kw)
    monkeypatch.setattr(R, "mask_encrypt_batch_ref", quantize)
    monkeypatch.setattr(R, "unmask_decrypt_batch_ref", dequantize)


# (transport, fault, the check that has to see it)
PROGRAM_FAULTS = [("full", _vote_takes_the_first_copy, "byzantine_mismatched"),
                  ("digest", _digests_ignored, "byzantine_mismatched"),
                  ("full", _masking_skipped, "launch_gap"),
                  ("digest", _masking_skipped, "launch_gap")]


@pytest.mark.parametrize("transport,fault,check", PROGRAM_FAULTS)
def test_program_faults_that_keep_the_sum_are_caught(bench, transport, fault,
                                                     check, monkeypatch):
    name = next(n for n in ALLREDUCE if harness.find_cell(bench, n)[2][
        "traffic"]["transport"] == transport)
    fault(monkeypatch)
    cell = tiny_cell(bench, name)
    out = driver(cell).run(cell)
    checks = {k: (v, lim) for k, v, lim in out.checks}
    assert checks["mismatched_elements"][0] == 0
    assert checks[check][0] > checks[check][1], out.checks
    assert not out.correct


def test_the_faulty_members_are_a_minority_of_each_cluster(bench):
    cell = tiny_cell(bench, ALLREDUCE[0])
    p = cell.config["protocol"]
    got = driver(cell).corrupt_members(cell)
    c = p["cluster_size"]
    assert [m // c for m in got] == list(range(p["n_nodes"] // c))
    cell.seed += 1
    assert len(driver(cell).corrupt_members(cell)) == len(got)


def _unchanged_state(step):
    def f(params, state, batch):
        p = copy.deepcopy(params)
        s = copy.deepcopy(state)
        _, _, met = step(p, s, batch)
        return params, state, met
    return f


def _half_the_batch(step):
    def f(params, state, batch):
        h = batch["tokens"].shape[0] // 2
        rest = {k: torch.cat([v[:h], v[:h]]) for k, v in batch.items()}
        return step(params, state, rest)
    return f


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_batch])
def test_training_faults_are_caught(bench, name, fault):
    cell = tiny_cell(bench, name)
    out = driver(cell).run(cell, fault=fault)
    assert not out.correct, out.checks


SECURE = [n for n in TRAIN
          if harness.find_cell(harness.load_json(
              harness.ROOT / "BENCHMARK.json"), n)[2]["traffic"]["sync"]
          == "secure"]


@pytest.mark.parametrize("name", SECURE)
@pytest.mark.parametrize("skipped", ["sync", "masking"])
def test_a_secure_step_without_its_sync_is_caught(bench, name, skipped,
                                                  monkeypatch):
    """The sync left out of the step, or run without its mask and unmask:
    at one party the gradients barely change, so only the launch check
    sees it."""
    from repro_torch.launch import steps as ST
    if skipped == "sync":
        monkeypatch.setattr(ST, "tree_allreduce",
                            lambda leaves, *a, **kw: list(leaves))
    else:
        _masking_skipped(monkeypatch)
    cell = tiny_cell(bench, name)
    out = driver(cell).run(cell)
    checks = {k: (v, lim) for k, v, lim in out.checks}
    assert checks["sync_launch_gap"][0] > 0
    assert not out.correct


@pytest.mark.parametrize("name", TRAIN)
def test_the_control_is_not_correct(bench, name):
    """The reference in float8 put in the program's place fails one of
    the cell's numbers."""
    cell = tiny_cell(bench, name)
    t, c = cell.traffic, cell.config
    batches = tokens.batches(SEED, 3, t["batch"], t["seq_len"],
                             c["vocab_size"], "cpu")
    secure = t["sync"] == "secure"
    want = qwen3.train_readings(c, SEED, batches, "cpu", secure=secure)
    low = qwen3.train_readings(c, SEED, batches, "cpu", secure=secure,
                               low=True)
    g = compare.gaps(low, want)
    assert any(g[k] > lim for k, lim in cell.limits.items()), g
