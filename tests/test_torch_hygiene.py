"""Rules the port keeps: no JAX and nothing of ``repro`` in ``repro_torch`` or
``chip_smoke.py``, copied modules equal to their originals, the card by
default, and a chip check that fails without a card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
COPIED = [
    "core/checkpoint.py", "core/steering.py", "core/tree_ser.py", "core/uid.py", "core/hyperslab.py",
    "core/codecs.py", "core/query.py", "core/container.py", "core/aggregation.py",
    "obs/metrics.py", "obs/trace.py",
]


def _imported_modules(path: pathlib.Path) -> list[str]:
    """Absolute module names a file imports (relative imports resolved within its package)."""
    package = path.relative_to(ROOT / "src").parent.parts if path.is_relative_to(ROOT / "src") else ()
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = list(package[: len(package) - node.level + 1]) if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names += [mod] + [f"{mod}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
            "__import__", "import_module"
        ):
            names += [a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _is_import_line(line: str) -> bool:
    return line.lstrip().startswith(("from ", "import "))


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_its_original(rel):
    note = f"Copied from ``src/repro/{rel}``; only the import lines differ."
    copy = (PORT / rel).read_text().splitlines()
    original = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    i = copy.index(note)
    assert copy[i - 1] == "" and i < 60, "the note closes the module docstring"
    copy = copy[: i - 1] + copy[i + 1 :]
    assert len(copy) == len(original)
    for n, (a, b) in enumerate(zip(copy, original), 1):
        assert a == b or (_is_import_line(a) and _is_import_line(b)), f"{rel}:{n}: {a!r} != {b!r}"


def test_entry_points_default_to_the_card():
    """Without a card, a scenario asked for no device raises: it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device works")
    from repro_torch.cfd.scenarios import karman_vortex, operation_theatre

    for build in (karman_vortex, operation_theatre):
        with pytest.raises((RuntimeError, AssertionError)):
            build(32, 64)
    cfg, state = karman_vortex(32, 64, device="cpu")
    assert state["u"].device.type == "cpu"


def _run_smoke(cwd: pathlib.Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
