"""The port imports nothing of JAX and nothing of the JAX package.

Every file under mic_tpu_torch/, chip_smoke.py and the port's tools
(tools/torch_*.py) is parsed, and every import statement in it, at module
level or inside a function, is checked: none may name jax, jaxlib, flax,
optax, orbax or mic_tpu (the package itself, not mic_tpu_torch).  Nor may
any import outside a function body name msgpack, safetensors, transformers
or huggingface_hub: the machine with the card has none of them, so such an
import would fail there only (the port reads the HF formats itself, and
imports huggingface_hub inside the hub functions alone).
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mic_tpu")
FORBIDDEN_OUTSIDE_FUNCTIONS = ("flax", "msgpack", "safetensors", "transformers",
                               "huggingface_hub")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", n) for n in os.listdir(os.path.join(REPO, "tools"))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "mic_tpu_torch")):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


def _imported(node) -> list[str]:
    if isinstance(node, ast.Import):
        return [alias.name for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module]
    return []


def forbidden_imports(source: str) -> list[str]:
    """The module names of every import of a forbidden package in source."""
    found = []
    for node in ast.walk(ast.parse(source)):
        found += [n for n in _imported(node) if n.split(".")[0] in FORBIDDEN]
    return found


def imports_outside_functions(source: str) -> list[str]:
    """The module names of every import of msgpack, safetensors,
    transformers, huggingface_hub or flax that is not inside a function
    body (module level, a class body, or an if/try at module level)."""
    found = []

    def visit(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        found.extend(n for n in _imported(node)
                     if n.split(".")[0] in FORBIDDEN_OUTSIDE_FUNCTIONS)
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(ast.parse(source))
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


def test_the_guard_sees_imports_outside_functions():
    source = (
        "import msgpack\nfrom safetensors.numpy import load_file\n"
        "try:\n    import transformers\nexcept ImportError:\n    pass\n"
        "class A:\n    from huggingface_hub import HfApi\n"
        "def f():\n    import huggingface_hub\n    from safetensors import torch\n"
        "async def g():\n    import msgpack\n"
        "import mic_tpu_torch.io.safetensors_np\nfrom flax import serialization\n"
    )
    assert imports_outside_functions(source) == [
        "msgpack", "safetensors.numpy", "transformers", "huggingface_hub", "flax",
    ]


def test_the_port_has_files_to_scan():
    files = _port_files()
    assert "chip_smoke.py" in files
    assert os.path.join("mic_tpu_torch", "models", "captioner.py") in files
    assert os.path.join("mic_tpu_torch", "core", "config.py") in files
    for module in ("flax_msgpack.py", "safetensors_np.py", "hf_import.py", "hf_export.py",
                   "hub.py"):
        assert os.path.join("mic_tpu_torch", "io", module) in files
    for tool in ("torch_ab_hard_synthetic.py", "torch_bench_trained.py",
                 "torch_validate_approx_decode.py", "torch_translate.py"):
        assert os.path.join("tools", tool) in files


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_no_jax_and_no_mic_tpu(path):
    with open(os.path.join(REPO, path)) as f:
        assert forbidden_imports(f.read()) == []


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_no_hf_library_outside_functions(path):
    with open(os.path.join(REPO, path)) as f:
        assert imports_outside_functions(f.read()) == []
