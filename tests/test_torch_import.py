"""Import boundaries between the two packages, checked in a fresh
interpreter (tests/conftest.py imports jax into every test process):
genomax_torch never imports jax, the host layer of genomax never imports
torch, and importing genomax_torch itself imports neither."""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loaded_after(imports):
    code = (f"import sys\nimport {', '.join(imports)}\n"
            "print(sorted(m for m in ('jax', 'torch') if m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=_REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-400:]
    return r.stdout.strip()


@pytest.mark.parametrize("imports,loaded", [
    (["genomax_torch"], "[]"),
    (["genomax_torch", "genomax_torch.engine.executor",
      "genomax_torch.cli.main", "genomax_torch.kernels.sw",
      "genomax_torch.kernels.wavefront", "genomax_torch.kernels.pairhmm",
      "genomax_torch.kernels.pairhmm_long", "genomax_torch.kernels.expand",
      "genomax_torch.pack"], "['torch']"),
    (["genomax.pack.bucketing", "genomax.io.formats", "genomax.layout",
      "genomax.config",
      "genomax.native", "genomax.kernels.oracle", "genomax.io.generator",
      "genomax.engine.executor"], "[]"),
], ids=["package", "port", "host_layer"])
def test_import_boundaries(imports, loaded):
    assert _loaded_after(imports) == loaded
