"""The port stands alone: nothing under src/repro_torch/ or tools/, and
not chip_smoke.py, imports jax, jaxlib or the JAX package `repro`; and its
entry points refuse to run without CUDA unless asked for the CPU."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"])


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_guard_sees_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.models import model\n"
                   "import importlib\nimportlib.import_module('jaxlib')\n"
                   "from repro_torch import bridge\n")
    found = [m.split(".")[0] for m in _imported_modules(src)]
    assert [m for m in found if m in FORBIDDEN] == ["jax", "repro", "jaxlib"]


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_serve_refuses_without_cuda(monkeypatch):
    from repro_torch.launch.serve import serve
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(["--smoke", "--continuous", "--requests", "1"])


def test_engine_refuses_without_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.serving import ServeEngine
    _no_cuda(monkeypatch)
    cfg = get_config("qwen3-0.6b", smoke=True)
    params = MD.init_model(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(params, cfg, num_slots=1, cache_len=8)
    eng = ServeEngine(params, cfg, num_slots=1, cache_len=8, device="cpu")
    assert eng.device.type == "cpu"


def test_unported_arch_names_ported_ids():
    """Every arch of the JAX registry is ported; an id outside it raises,
    naming the known ids."""
    from repro_torch.configs import ARCH_IDS, get_config
    assert len(ARCH_IDS) == 10
    with pytest.raises(KeyError, match="qwen3-0.6b"):
        get_config("no-such-arch")
