"""The port's multi-process self-test, and the distributed path's hard
failures: a rank that dies, and a process group that cannot start, end
the run with an error -- nothing falls back to the sim oracle."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


def _run(args, timeout):
    return subprocess.run([sys.executable, *args], env=ENV, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_selftest_8_ranks_on_cpu():
    """Every schedule x transport x masking on a ("data",) and a ("pod",
    "data") mesh of 8 gloo ranks: mesh == sim bit for bit, within the
    quantization bound of the plain sum, Byzantine flips corrected."""
    proc = _run(["-m", "repro_torch.launch.selftest", "--ranks", "8",
                 "--device", "cpu"], timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert proc.stdout.rstrip().endswith("selftest OK")
    assert proc.stdout.count("[PASS]") == 2 * 24 * 3
    assert "[FAIL]" not in proc.stdout


def test_a_rank_that_dies_fails_the_run():
    proc = _run([str(ROOT / "tests" / "torch_mesh_workers.py"), "--die"],
                timeout=120)
    assert proc.returncode != 0
    assert "ProcessExitedException" in proc.stderr, proc.stderr[-4000:]


def test_a_group_that_cannot_start_raises(tmp_path):
    """Rank 0 of a world of 2 whose peer never joins: the store's wait
    times out and raises."""
    code = ("from repro_torch.runtime.compat import init_node_group; "
            f"init_node_group(0, 2, {str(tmp_path / 'store')!r}, "
            "timeout_s=3)")
    proc = _run(["-c", code], timeout=120)
    assert proc.returncode != 0
    assert "imeout" in proc.stderr or "imed out" in proc.stderr, \
        proc.stderr[-4000:]
