"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no file of it (nor chip_smoke.py) imports either — the card's
host has no JAX."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PKG = os.path.join(ROOT, "tpu_ir_torch")

_IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|tpu_ir|bench)(?:\.|\s|$)", re.M)


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, tpu_ir_torch, tpu_ir_torch.search.scorer, "
            "tpu_ir_torch.index.builder, tpu_ir_torch.cli, "
            "tpu_ir_torch.convert, tpu_ir_torch.corpus, "
            "tpu_ir_torch.ops._build, chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_ir', 'bench'))\n"
            "assert not bad, bad\n"
            "print('clean')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "clean"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_tpu_ir_import_in_source(path):
    src = open(path, encoding="utf-8").read()
    assert not _IMPORT_RE.search(src), path


def test_kernel_sources_are_listed():
    from tpu_ir_torch.ops import _build

    assert _build.kernel_sources() == ["dense_score"]
    assert _build.BUILD_DIR.parts[-2:] == ("build", "tpu_ir_torch")
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert "build/" in ignored
