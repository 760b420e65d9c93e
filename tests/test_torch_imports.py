"""The port stands alone: importing algebra_tpu_torch and every submodule
pulls in neither jax nor the JAX package, needs no CUDA, nvcc or triton,
and the chip smoke script imports neither as well."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WALK = """
import importlib, pkgutil, sys
import algebra_tpu_torch
names = ["algebra_tpu_torch"]
for mod in pkgutil.walk_packages(algebra_tpu_torch.__path__, prefix="algebra_tpu_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "algebra_tpu", "triton"))
print("MODULES", len(names), "BAD", bad)
print("NAMES", " ".join(names))
import torch
from algebra_tpu_torch import config
print("CUDA", torch.cuda.is_available(), "DEFAULT", config.default_device)
"""


def _imports_of(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(node.module.split(".")[0])
    return found


def test_package_imports_without_jax_or_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _WALK], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n_modules = int(out.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 30, out.stdout
    names = set(out.stdout.split("NAMES")[1].split())
    assert {"algebra_tpu_torch.curves.sw", "algebra_tpu_torch.ops.msm",
            "algebra_tpu_torch.ops.sw_kernels", "algebra_tpu_torch.fields.host",
            "algebra_tpu_torch.ops.rows", "algebra_tpu_torch.curves.te",
            "algebra_tpu_torch.curves.instances.secp256k1",
            "algebra_tpu_torch.curves.instances.ed_on_bls12_381",
            "algebra_tpu_torch.ops.glv", "algebra_tpu_torch.ops.wnaf",
            "algebra_tpu_torch.ops.fixed_base", "algebra_tpu_torch.entry",
            "algebra_tpu_torch.fields.dot", "algebra_tpu_torch.fields.host_tower",
            "algebra_tpu_torch.fields.quadratic", "algebra_tpu_torch.fields.cubic",
            "algebra_tpu_torch.fields.fp12", "algebra_tpu_torch.fields.element",
            "algebra_tpu_torch.pairing", "algebra_tpu_torch.pairing.common",
            "algebra_tpu_torch.pairing.bls12", "algebra_tpu_torch.pairing.gt",
            "algebra_tpu_torch.pairing.bn", "algebra_tpu_torch.curves.instances.bn254",
            "algebra_tpu_torch.curves.instances._derive"} <= names
    assert "DEFAULT cuda" in out.stdout


def test_no_source_file_imports_jax():
    forbidden = {"jax", "jaxlib", "algebra_tpu"}
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "algebra_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 34
    pairing = os.path.join(REPO, "algebra_tpu_torch", "pairing")
    assert {os.path.join(pairing, n)
            for n in ("common.py", "bls12.py", "bn.py", "gt.py")} <= set(files)
    instances = os.path.join(REPO, "algebra_tpu_torch", "curves", "instances")
    assert {os.path.join(instances, n) for n in ("bn254.py", "_derive.py")} <= set(files)
    for path in files:
        assert not (_imports_of(path) & forbidden), path


def test_kernel_sources_are_in_the_package():
    csrc = os.path.join(REPO, "algebra_tpu_torch", "csrc")
    from algebra_tpu_torch.kernels import build

    sources = {f"{src}.cu" for src in build.KERNEL_SOURCES}
    assert sources == {"mont_kernels.cu", "inverse_kernels.cu", "sw_kernels.cu",
                       "rows_kernels.cu", "msm_reduce_kernels.cu", "dot_kernels.cu"}
    headers = {"mont.cuh", "launch.cuh", "sw.cuh", "rows.cuh", "msm_reduce.cuh",
               "inverse.cuh", "dot.cuh"}
    assert sources | headers <= set(os.listdir(csrc))
    assert set(build._HEADERS) == headers
    # one library per source and word count, named after a hash of the sources
    paths = {build.library_path(src, w)
             for src in build.KERNEL_SOURCES for w in build.WORD_COUNTS}
    assert len(paths) == 18 and all("_build" in p for p in paths)
    assert set(build._signatures()) == set(build.KERNEL_SOURCES)
