"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
(`lattice_tpu`), top-level names compared whole, so that
`lattice_tpu_torch` is not taken for it; and the references import
nothing of the program."""

import ast
import json
import subprocess
import sys
import textwrap

from benchmark import run

SCRIPT = textwrap.dedent('''
    import importlib.abc, json, sys
    BLOCKED = {"jax", "jaxlib", "flax", "lattice_tpu"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, ROOT)
    from benchmark import run
    for cell, tiny in TINY.items():
        for trace in (False, True):
            assert run.run_cell(cell, 7, 0.2, trace, device="cpu",
                                overrides=tiny)["correct"]
    for kind in ("drivers", "metrics"):
        for path in sorted((run.HERE / kind).glob("*.py")):
            run.load_named(kind, path.stem)
    import benchmark.calibrate
    print(json.dumps([run.blocked_modules(),
                      "lattice_tpu_torch" in sys.modules]))
''')


def test_no_jax_in_a_run(tiny):
    code = f"ROOT = {str(run.ROOT)!r}\nTINY = {json.dumps(tiny)}\n" + SCRIPT
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=run.ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    # the port ran in that process: its name begins with the JAX
    # package's, and only whole top-level names are compared
    assert json.loads(done.stdout.strip().splitlines()[-1]) == [[], True]


def test_the_references_import_nothing_of_the_program():
    for path in sorted((run.HERE / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top in {"__future__", "contextlib", "math", "numpy",
                               "torch", "benchmark"}, (path.name, name)
                assert not name.startswith("benchmark.") or name.startswith(
                    "benchmark.reference"), (path.name, name)
