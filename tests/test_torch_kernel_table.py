"""Every TPU kernel of the JAX package has a counterpart in the port.

The functions under ``src/repro/kernels/`` that reach ``pl.pallas_call``
are found by reading the source text (the port never imports the JAX
package).  Each must be named, as ``file:line`` of its ``def``, by the
``replaces`` field of one kernel in ``repro_torch.kernels.backend.KERNELS``
or by its ``row_form`` (a single-row form the port runs as B = 1); one
site may have more than one port (a kernel and a kernel that runs the
reference's loop around it, ``loop``).  Two kernels port a function
with no Pallas site (``pallas=False``): the flash backward, the
reference's jnp custom VJP, and the SSD backward, JAX's autodiff of the
reference's jnp ``ssd_chunked``.
"""
import ast
import pathlib

import pytest

from repro_torch.kernels import backend

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNEL_DIR = ROOT / "src" / "repro" / "kernels"


def _calls_pallas(fn: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == "pallas_call" for n in ast.walk(fn))


def pallas_sites() -> list[str]:
    """file:line of every top-level function that calls ``pallas_call``."""
    sites = []
    for path in sorted(KERNEL_DIR.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        rel = path.relative_to(ROOT).as_posix()
        sites += [f"{rel}:{node.lineno}" for node in tree.body
                  if isinstance(node, ast.FunctionDef) and _calls_pallas(node)]
    return sites


def test_the_scan_finds_all_eight_sites():
    assert len(pallas_sites()) == 8


@pytest.mark.parametrize("site", pallas_sites())
def test_every_pallas_kernel_has_a_port(site):
    named = {k.replaces for k in backend.KERNELS} | \
        {k.row_form for k in backend.KERNELS if k.row_form}
    assert site in named, f"{site} has no counterpart in backend.KERNELS"


@pytest.mark.parametrize("kernel", backend.KERNELS, ids=lambda k: k.name)
def test_every_port_names_a_pallas_kernel_and_its_source(kernel):
    """Every kernel names its source and the TPU kernel it ports; the two
    kernels whose reference function has no Pallas site (``pallas=False``:
    the flash backward, a jnp custom VJP, and the SSD backward, autodiff of
    jnp code) name that function's ``def`` instead."""
    sites = pallas_sites()
    if kernel.pallas:
        assert kernel.replaces in sites
    else:
        path, line = kernel.replaces.rsplit(":", 1)
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def "), text
        assert kernel.replaces not in sites
    assert kernel.row_form is None or kernel.row_form in sites
    assert (ROOT / kernel.source).is_file()


def test_the_flash_backward_replaces_the_reference_vjp():
    """The training slice's kernel: the FA-2 backward of the reference's
    custom VJP, ``_flash_core_bwd``, and no Pallas kernel."""
    k = backend.FLASH_ATTENTION_BWD
    assert k in backend.KERNELS and not k.pallas
    assert k.replaces == "src/repro/models/layers.py:172"
    text = (ROOT / "src/repro/models/layers.py").read_text().splitlines()
    assert text[171].startswith("def _flash_core_bwd(")
    assert k.source == "src/repro_torch/csrc/flash_attention_bwd.cu"
    assert [x.name for x in backend.KERNELS if not x.pallas] == \
        ["flash_attention_bwd", "ssd_bwd"]


def test_the_ssd_backward_replaces_autodiff_of_ssd_chunked():
    """The Mamba2 training slice's kernel: the gradient of the reference's
    jnp ``ssd_chunked``, which JAX takes by autodiff, and no Pallas
    kernel."""
    k = backend.SSD_BWD
    assert k in backend.KERNELS and k in backend.MODEL and not k.pallas
    assert k.replaces == "src/repro/models/layers.py:709"
    text = (ROOT / "src/repro/models/layers.py").read_text().splitlines()
    assert text[708].startswith("def ssd_chunked(")
    assert k.source == "src/repro_torch/csrc/ssd_bwd.cu"


@pytest.mark.parametrize("kernel", [k for k in backend.KERNELS if k.loop],
                         ids=lambda k: k.name)
def test_a_kernel_that_runs_a_reference_loop_names_it(kernel):
    """A kernel that also runs the reference's host-side loop around a
    TPU kernel (the Montgomery ladder around ``mont_mul``) names that
    loop's ``def`` by file:line, beside the TPU kernel it replaces."""
    path, line = kernel.loop.rsplit(":", 1)
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith("def "), text
    assert kernel.replaces in pallas_sites()


def test_two_ports_may_share_one_pallas_site():
    """``mont_mul`` and the ladder ``mont_exp`` both replace modmul.py's
    ``mont_mul``: one product, and the whole loop of products."""
    site = backend.MONT_MUL.replaces
    assert backend.MONT_EXP.replaces == site
    assert backend.MONT_EXP.loop == "src/repro/kernels/modmul/ops.py:23"
