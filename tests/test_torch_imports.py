"""The port imports neither JAX nor the JAX package.

An AST scan, because this image's interpreter imports JAX at start-up, so
sys.modules cannot show what the port itself imports."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "awm_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "awm_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            yield from (a.value for a in node.args[:1] if isinstance(a, ast.Constant))


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_scan_covers_the_port():
    files = _port_files()
    assert os.path.join(REPO, "chip_smoke.py") in files
    for name in ("api.py", "bench.py", os.path.join("tools", "bench_sweep.py"),
                 os.path.join("tools", "demo_table.py")):
        assert os.path.join(REPO, "awm_tpu_torch", name) in files, name
    assert all(os.path.exists(f) for f in files)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_forbidden_rule():
    assert _forbidden("awm_tpu.api") and _forbidden("jax.numpy") and _forbidden("orbax.checkpoint")
    assert not _forbidden("awm_tpu_torch.api") and not _forbidden("torch")
