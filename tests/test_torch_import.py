"""The port stands alone: importing every module under ``genomax_torch``
brings in neither jax nor any module of the JAX package, the on-card smoke
script and its shared cases import neither, and the native golden library
builds from the port's own source into the port's build directory."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WALK = """
import importlib, json, pkgutil, sys
import genomax_torch
names = ["genomax_torch"] + [m.name for m in pkgutil.walk_packages(
    genomax_torch.__path__, "genomax_torch.")]
for n in names:
    if n != "genomax_torch.__main__":
        importlib.import_module(n)
import genomax_torch.engine.executor, genomax_torch.cli.main
from genomax_torch import native
bad = [k for k in sys.modules if k in ("jax", "jaxlib", "genomax")
       or k.startswith(("jax.", "jaxlib.", "genomax."))]
print(json.dumps({"modules": names, "bad": bad, "native": native.build(),
                  "loaded_so": [l.split()[-1] for l in open("/proc/self/maps")
                                if l.rstrip().endswith(".so")
                                and "golden" in l]}))
"""


@pytest.fixture(scope="module")
def walked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _WALK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_imports_without_jax_or_genomax(walked):
    assert walked["bad"] == []


@pytest.mark.parametrize("name", [
    "genomax_torch.layout", "genomax_torch.config", "genomax_torch.io.formats",
    "genomax_torch.io.phred", "genomax_torch.io.generator",
    "genomax_torch.native", "genomax_torch.pack.bucketing",
    "genomax_torch.pack.nibble", "genomax_torch.pack.tensors", "genomax_torch.engine.executor",
    "genomax_torch.engine.stream",
    "genomax_torch.kernels.sw", "genomax_torch.kernels.sw_long",
    "genomax_torch.kernels.sw_strips", "genomax_torch.kernels.sw_rotor",
    "genomax_torch.kernels.sw_stacked", "genomax_torch.kernels.sw_conveyor",
    "genomax_torch.kernels.pairhmm", "genomax_torch.kernels.pairhmm_long",
    "genomax_torch.kernels.wavefront", "genomax_torch.cli.main",
    "genomax_torch.dist", "genomax_torch.dist.mesh",
    "genomax_torch.dist.sharded", "genomax_torch.dist.engine",
    "genomax_torch.dist.xsharded", "genomax_torch.kernels.oracle",
    "genomax_torch.testing", "genomax_torch.testing.parity",
    "genomax_torch.testing.soak", "genomax_torch.bench",
    "genomax_torch.bench.sweep", "genomax_torch.bench.scaling"])
def test_module_is_part_of_the_walk(walked, name):
    assert name in walked["modules"]


@pytest.mark.parametrize("name,module", [
    ("Engine", "genomax_torch.engine.executor"),
    ("EngineConfig", "genomax_torch.config"),
    ("SWConfig", "genomax_torch.config"),
    ("PairHMMConfig", "genomax_torch.config")])
def test_lazy_export(name, module):
    import importlib

    import genomax_torch

    assert getattr(genomax_torch, name) is getattr(
        importlib.import_module(module), name)


def test_native_builds_into_the_ports_build_dir(walked):
    build_dir = os.path.join(REPO, "genomax_torch", "_build")
    assert os.path.dirname(walked["native"]) == build_dir
    assert os.path.exists(walked["native"])


def test_jax_packages_library_is_never_loaded():
    """Loading the port's native model maps its own library and not
    genomax/native/_golden.so."""
    code = ("from genomax_torch import native; native.load(); "
            "print([l.split()[-1] for l in open('/proc/self/maps') "
            "if 'golden' in l])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mapped = set(eval(out.stdout.strip().splitlines()[-1]))
    assert mapped and all(
        os.path.dirname(p) == os.path.join(REPO, "genomax_torch", "_build")
        for p in mapped)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", ["chip_smoke.py", "tests/_phmm_cases.py",
                                 "tests/test_torch_kernel.py",
                                 "tests/_torch_dist_worker.py"])
def test_script_imports_neither_jax_nor_genomax(rel):
    roots = _imported_roots(os.path.join(REPO, rel))
    assert not roots & {"jax", "jaxlib", "genomax"}


def test_package_sources_name_no_genomax_import():
    """No source under genomax_torch imports jax or genomax, lazily or at
    the top."""
    pkg = os.path.join(REPO, "genomax_torch")
    checked = 0
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                roots = _imported_roots(os.path.join(root, f))
                assert not roots & {"jax", "jaxlib", "genomax"}, f
                checked += 1
    assert checked >= 15
