"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or repro (the name before the first dot, compared whole: repro_torch is
the program), and nothing of the program in the reference."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench import harness

RUN_DIRS = ("", "drivers", "frozen")


def _imports(path: Path):
    """Every module an ``import`` in ``path`` names, inside functions too."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def _run_files():
    for d in RUN_DIRS:
        yield from sorted((harness.HERE / d).glob("*.py"))


# every module of the harness a run or a control reading can load, and
# what they import of the program (the drivers do so lazily, in a run)
HARNESS = ["portbench." + ".".join(
    p.relative_to(harness.HERE).with_suffix("").parts)
    for p in _run_files() if p.stem != "__init__"]
PROGRAM = sorted({m for p in _run_files() for m in _imports(p)
                  if m.split(".")[0] == "repro_torch"})
# ``from package import name``, where the name is a module of the package
SUBMODULES = sorted({f"{n.module}.{a.name}" for p in _run_files()
                     for n in ast.walk(ast.parse(p.read_text()))
                     if isinstance(n, ast.ImportFrom) and n.module
                     and n.module.split(".")[0] == "repro_torch"
                     for a in n.names})
REFERENCE = ["portbench.reference." + p.stem for p in sorted(
    (harness.HERE / "reference").glob("*.py")) if p.stem != "__init__"]


def _loaded_tops(modules, maybe=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(harness.ROOT), str(harness.ROOT / "src")]))
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"for m in {list(maybe)!r}:\n"
            "    try:\n"
            "        spec = importlib.util.find_spec(m)\n"
            "    except ModuleNotFoundError:\n"
            "        spec = None   # a name, and no module, of its parent\n"
            "    if spec: importlib.import_module(m)\n"
            "from portbench import harness\n"
            "for p in sorted((harness.HERE / 'metrics').glob('*.py')):\n"
            "    harness.load_metric(p.stem)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax_and_no_reference_package():
    tops = _loaded_tops(HARNESS + PROGRAM, SUBMODULES)
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded_tops(REFERENCE)
    assert not tops & (set(harness.FORBIDDEN) | {"repro_torch"})


def test_the_reference_imports_name_nothing_of_the_program():
    for path in sorted((harness.HERE / "reference").glob("*.py")):
        for n in _imports(path):
            assert n.split(".")[0] not in (
                set(harness.FORBIDDEN) | {"repro_torch"}), (path, n)
