"""The port stands alone: no module of it imports ``jax``, the JAX
package, ``aiohttp`` or ``prometheus_client`` (the card's machine has
neither of the last two), and it imports in a process where those imports
raise.

``ops/kernels/_triton_fused.py`` imports ``triton`` at module level (it is
loaded only by the launching functions, on a machine with a card), so the
import test skips that one module where ``triton`` is missing.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import distributed_inference_server_tpu_torch as port

PKG_DIR = pathlib.Path(port.__file__).resolve().parent
ROOT = PKG_DIR.parent
JAX_PKG = "distributed_inference_server_tpu"
FORBIDDEN = ("jax", "jaxlib", JAX_PKG, "aiohttp", "prometheus_client")


def _port_files():
    files = sorted(PKG_DIR.rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_no_module_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}"
                          for n in names if _forbidden(n)]
    assert offenders == []


def test_port_imports_where_jax_cannot():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG_DIR.rglob("*.py")
        if p.name != "__init__.py" or p.parent != PKG_DIR
    )
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    script = textwrap.dedent(f"""
        import importlib, importlib.util, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        has_triton = importlib.util.find_spec("triton") is not None
        for m in {modules!r}:
            if m.endswith("_triton_fused") and not has_triton:
                continue
            importlib.import_module(m)
        leaked = [k for k in sys.modules
                  if k.split(".")[0] in {FORBIDDEN!r}]
        assert not leaked, leaked
        print("ok", len({modules!r}))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result
    line."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
