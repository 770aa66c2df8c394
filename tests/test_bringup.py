"""Backend hygiene: no TPU-only code in the package, the compile cache at
its one fixed place, and chip_smoke.py refusing to run without a GPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import tpu_hnsw

REPO = pathlib.Path(tpu_hnsw.__file__).resolve().parent.parent


_PALLAS = ["jax", "experimental", "pallas"]


def _is_tpu_pallas(module: str) -> bool:
    return module.split(".")[:4] == [*_PALLAS, "tpu"]


def _tpu_only_sites(path: pathlib.Path) -> list[str]:
    """Imports of Pallas' TPU module and comparisons against "tpu"."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if _is_tpu_pallas(mod) or any(
                    _is_tpu_pallas(f"{mod}.{a.name}") for a in node.names):
                found.append(f"{path}:{node.lineno} imports Pallas' TPU module")
        elif isinstance(node, ast.Import):
            if any(_is_tpu_pallas(a.name) for a in node.names):
                found.append(f"{path}:{node.lineno} imports Pallas' TPU module")
        elif isinstance(node, ast.Compare):
            for operand in [node.left, *node.comparators]:
                if (isinstance(operand, ast.Constant)
                        and isinstance(operand.value, str)
                        and operand.value.lower() == "tpu"):
                    found.append(f"{path}:{node.lineno} compares with 'tpu'")
    return found


def test_no_tpu_only_code_in_package():
    sites = []
    for path in sorted((REPO / "tpu_hnsw").rglob("*.py")):
        sites += _tpu_only_sites(path)
    assert not sites, "\n".join(sites)


@pytest.mark.parametrize("env_dir", [True, False],
                         ids=["env-dir", "checkout-default"])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is where compiled programs
    land; unset, they land in <checkout>/.jax_cache. Nothing is written
    under HOME."""
    home = tmp_path / "home"
    home.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(HOME=str(home), JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="true",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    want = REPO / ".jax_cache"
    if env_dir:
        want = tmp_path / "cache"
        env["JAX_COMPILATION_CACHE_DIR"] = str(want)
    code = ("import jax, jax.numpy as jnp, tpu_hnsw\n"
            "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7.0)).block_until_ready()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == str(want)
    assert want.is_dir() and any(want.iterdir())
    assert not (home / ".cache").exists()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    """With no GPU, chip_smoke.py exits non-zero and prints no ok line,
    in the repo and in a directory holding nothing else of it."""
    cwd = REPO
    if where == "alone":
        cwd = tmp_path
        shutil.copy(REPO / "chip_smoke.py", cwd / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
