"""The port and ``chip_smoke.py`` import nothing of JAX and nothing of the
JAX package: an AST scan of every module, and a fresh interpreter that
imports the whole port and finds no ``jax`` in ``sys.modules``.  The
subprocess is needed because ``tests/conftest.py`` imports jax."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pytorch_video_action_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "pytorch_video_action_tpu")
# the port's own modules; its gitignored build directory holds no Python
MODULES = sorted(p for p in PORT.rglob("*.py") if "_build" not in p.parts)
FILES = MODULES + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "torch_profile_inference.py",
    ROOT / "tests" / "test_torch_cuda_kernels.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_forbidden_name_match_is_exact():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("pytorch_video_action_tpu.ops.rnn")
    assert not _forbidden("pytorch_video_action_tpu_torch.ops.rnn")
    assert not _forbidden("jaxtyping_like")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_no_jax(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    mods = sorted(".".join(("pytorch_video_action_tpu_torch",
                            *p.relative_to(PORT).with_suffix("").parts))
                  for p in MODULES if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'pytorch_video_action_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
