"""The port imports nothing of JAX and nothing of the JAX package.

Every file under mic_tpu_torch/, chip_smoke.py and the port's tools
(tools/torch_*.py) is parsed, and every import statement in it, at module
level or inside a function, is checked: none may name jax, jaxlib, flax,
optax, orbax or mic_tpu (the package itself, not mic_tpu_torch).
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mic_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", n) for n in os.listdir(os.path.join(REPO, "tools"))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "mic_tpu_torch")):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


def forbidden_imports(source: str) -> list[str]:
    """The module names of every import of a forbidden package in source."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def test_the_guard_sees_every_form_of_import():
    source = (
        "import jax\nimport jax.numpy as jnp\nfrom flax import linen\n"
        "import os, optax\nfrom mic_tpu.core import config\nimport mic_tpu\n"
        "def f():\n    from jaxlib import xla_client\n    import mic_tpu.data.loader\n"
        "import mic_tpu_torch\nfrom mic_tpu_torch.core import config\nfrom . import x\n"
        "import orbax.checkpoint as ocp\n"
    )
    assert forbidden_imports(source) == [
        "jax", "jax.numpy", "flax", "optax", "mic_tpu.core", "mic_tpu", "orbax.checkpoint",
        "jaxlib", "mic_tpu.data.loader",
    ]


def test_the_port_has_files_to_scan():
    files = _port_files()
    assert "chip_smoke.py" in files
    assert os.path.join("mic_tpu_torch", "models", "captioner.py") in files
    assert os.path.join("mic_tpu_torch", "core", "config.py") in files
    for tool in ("torch_ab_hard_synthetic.py", "torch_bench_trained.py",
                 "torch_validate_approx_decode.py"):
        assert os.path.join("tools", tool) in files


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_no_jax_and_no_mic_tpu(path):
    with open(os.path.join(REPO, path)) as f:
        assert forbidden_imports(f.read()) == []
