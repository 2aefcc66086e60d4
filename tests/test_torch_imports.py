"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the smoke script refuses to run
without a CUDA device or outside a checkout."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None        # any import of these now raises
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = [m for m, mod in sys.modules.items() if mod is not None
       and (m.split(".")[0] in ("jax", "repro"))]
assert not bad, bad
print("imports ok")
"""


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(args, capture_output=True, text=True,
                          timeout=120, env=env, **kw)


def test_port_imports_with_jax_and_reference_blocked():
    r = _run([sys.executable, "-c",
              _BLOCKED_IMPORT.format(src=str(SRC), root=str(ROOT))])
    assert r.returncode == 0, r.stderr
    assert "imports ok" in r.stdout


_IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)"
    r"|import_module\(\s*['\"](?:jax|repro)(?:\.|['\"])"
    r"|__import__\(\s*['\"](?:jax|repro)(?:\.|['\"])", re.M)


def test_no_source_names_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 10
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _IMPORT_RE.finditer(f.read_text())]
    assert not hits, hits


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_without_cuda_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    r = _run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"ok"' not in r.stdout
