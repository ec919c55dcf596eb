"""The port stands alone: nothing under src/repro_torch/ or tools/, and
not chip_smoke.py, imports jax, jaxlib or the JAX package `repro`; and its
entry points refuse to run without CUDA unless asked for the CPU."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

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


# the modules a proc-transport worker child loads (its entry point, the
# role registry, the server roles' state, the trace types and obs): they
# must load without torch, or every child would pay its import
CHILD_MODULES = ("repro_torch.cluster.proc", "repro_torch.cluster.roles",
                 "repro_torch.cluster.transport",
                 "repro_torch.elastic.membership",
                 "repro_torch.core.param_server",
                 "repro_torch.core.replay_shard", "repro_torch.obs")


def _module_path(name):
    base = ROOT / "src" / pathlib.Path(*name.split("."))
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _import_time_modules(path):
    """Modules imported when `path` is imported: its import statements
    outside function bodies (a function's imports run when it is called)
    and outside `if TYPE_CHECKING:` blocks."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if (isinstance(child, ast.If)
                    and getattr(child.test, "id", "") == "TYPE_CHECKING"):
                child = ast.Module(body=child.orelse, type_ignores=[])
            if isinstance(child, ast.Import):
                yield from (a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module
                yield from (f"{child.module}.{a.name}" for a in child.names)
            else:
                yield from walk(child)
    return set(walk(ast.parse(path.read_text(), filename=str(path))))


def _loaded_by(name):
    """Every module importing `name` loads, following the port's own
    modules (and their packages' __init__) through the ast."""
    seen, todo, out = set(), [name], set()
    while todo:
        mod = todo.pop()
        parts = mod.split(".")
        for i in range(1, len(parts) + 1):
            sub = ".".join(parts[:i])
            out.add(sub)
            if sub.startswith("repro_torch") and sub not in seen \
                    and _module_path(sub).exists():
                seen.add(sub)
                todo.extend(_import_time_modules(_module_path(sub)))
    return out


@pytest.mark.parametrize("name", CHILD_MODULES)
def test_child_modules_import_no_torch(name):
    """No torch (nor jax); numpy only for the two server-role states, the
    rest is stdlib only, as in the JAX package."""
    top = {m.split(".")[0] for m in _loaded_by(name)}
    forbidden = {"torch", "jax", "jaxlib", "repro"}
    if not name.startswith("repro_torch.core"):
        forbidden.add("numpy")
    assert not top & forbidden, top & forbidden


def test_child_module_walk_sees_torch():
    """The walk follows the port's imports: the coordinator reaches torch
    (through the straggler's batch split), a function-local import does
    not count."""
    assert "torch" in _loaded_by("repro_torch.cluster.coordinator")
    assert "torch" not in _loaded_by("repro_torch.cluster.proc")


_PROBE_ROLE = """\
import sys
from repro_torch.cluster import roles

def _probe(state, cmd):
    for name in cmd["load"]:
        __import__(name)
    return {"modules": sorted(m for m in ("torch", "jax", "repro", "numpy")
                              if m in sys.modules)}

roles.register(roles.RoleSpec("probe", open_verb="probe_open",
                              make=lambda cmd: {},
                              verbs={"probe_modules": _probe}))
"""


def test_proc_child_runs_without_torch(tmp_path, monkeypatch):
    """A worker child that the port's ProcTransport starts, after it has
    loaded every child module and opened the ps, replay and learner
    roles, holds no torch (nor jax) in sys.modules."""
    import os
    from repro_torch.cluster import ProcTransport
    (tmp_path / "torch_probe_role.py").write_text(_PROBE_ROLE)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    exec(_PROBE_ROLE.replace("roles.register", "roles.lookup('probe_modules') "
                             "or roles.register"), {})
    with ProcTransport(role_modules=["torch_probe_role"],
                       device="cpu") as proc:
        proc.start(1)
        proc.role_open(0, "probe")
        first = proc.role_call(0, "probe_modules", {"load": []})
        assert first["modules"] == []
        proc.ps_open(0, lr=0.1, entries={"w": [1.0, 2.0]})
        proc.role_open(0, "replay", capacity=4)
        proc.role_open(0, "learner")
        reply = proc.role_call(0, "probe_modules",
                               {"load": list(CHILD_MODULES)})
        assert reply["modules"] == ["numpy"]


def test_proc_transport_refuses_without_cuda(monkeypatch):
    from repro_torch.cluster import ProcTransport
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProcTransport()
    assert ProcTransport(device="cpu").device.type == "cpu"


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


# the mesh slice's modules: jax-free like every port file (the
# parametrized guard above reads their imports), and hypar is a pure-
# Python copy that loads neither torch nor jax
MESH_MODULES = ("repro_torch.core.sharding", "repro_torch.core.pipeline",
                "repro_torch.core.decoupled", "repro_torch.core.hypar",
                "repro_torch.launch.mesh")


@pytest.mark.parametrize("name", MESH_MODULES)
def test_mesh_modules_load_no_jax(name):
    top = {m.split(".")[0] for m in _loaded_by(name)}
    assert not top & {"jax", "jaxlib", "repro"}, top
    if name.endswith("hypar"):
        assert not top & {"torch", "numpy"}, top


def test_train_mesh_refuses_without_enough_cards(monkeypatch):
    from repro_torch.launch.train import train
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        train(["--smoke", "--device", "cuda", "--data", "2", "--model",
               "2", "--steps", "1"])


@pytest.mark.parametrize("mode", ["sync", "local_sgd", "easgd", "async_ps",
                                  "ssp"])
def test_train_mesh_accepts_elastic_in_every_mode(mode):
    """No option of either launcher is refused under a mesh any more:
    `--elastic` parses with --data 2 --model 2 in every mode (and `serve
    --replicas --transport proc` runs there, tests/test_torch_serve_
    mesh.py)."""
    from repro_torch.launch.train import parse_args
    args = parse_args(["--smoke", "--device", "cpu", "--data", "2",
                       "--model", "2", "--elastic", "--mode", mode,
                       "--ckpt-dir", "unused", "--transport", "proc"])
    assert args.elastic and args.mode == mode and args.async_ckpt


def test_train_mesh_refuses_a_batch_the_data_dim_does_not_divide():
    """As JAX's NamedSharding would: dp_tp splits the batch over the 2
    data ranks, so --batch 3 cannot be placed; tp splits none."""
    from repro_torch.launch.train import parse_args
    argv = ["--smoke", "--device", "cpu", "--data", "2", "--model", "2",
            "--batch", "3"]
    with pytest.raises(SystemExit):
        parse_args(argv)
    assert parse_args(argv + ["--env", "tp"]).batch == 3


# the RL and classic slices: their packages load without torch (the
# exports are lazy), and their entry points refuse to run without a card
@pytest.mark.parametrize("name", ["repro_torch.rl", "repro_torch.classic"])
def test_rl_and_classic_packages_import_without_torch(name):
    import subprocess
    import sys
    code = (f"import sys, {name} as m; m.__doc__; "
            "print(sorted(x for x in ('torch', 'jax', 'repro') "
            "if x in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


def test_rl_launcher_refuses_without_cuda(monkeypatch):
    from repro_torch.launch.rl import rl
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        rl(["--steps", "1"])


def test_run_fleet_refuses_without_cuda(monkeypatch):
    from repro_torch.rl.fleet import run_fleet
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fleet(steps=1, evaluate=False)
    assert run_fleet(steps=1, batch=64, evaluate=False,
                     device="cpu").env_steps == 4 * 16
