"""Nothing under benchmark/ imports JAX or the JAX package: each import's
top-level module name is compared whole, so the port
(diffusionhandles_tpu_torch) passes and diffusionhandles_tpu does not."""

import ast
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "diffusionhandles_tpu"}


def imported_tops(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(BENCH.rglob("*.py")),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    bad = FORBIDDEN & set(imported_tops(path))
    assert not bad, f"{path} imports {bad}"


def test_names_compared_whole():
    src = "import diffusionhandles_tpu_torch.ops\nimport jaxtyping\n"
    tmp = BENCH / "tests" / "fixture"
    probe = tmp / "_probe_imports.txt"
    probe.write_text(src)
    try:
        assert not FORBIDDEN & set(imported_tops(probe))
        probe.write_text("from diffusionhandles_tpu.ops import conv\n")
        assert FORBIDDEN & set(imported_tops(probe)) == {
            "diffusionhandles_tpu"}
    finally:
        probe.unlink()


MODEL_KEYS = {"unet", "vae", "text_encoder"}
MODEL_IMPORTS = ("diffusionhandles_tpu_torch.models", "benchmark.reference")


def imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("name", ["harness.py", "tap.py", "run.py"])
def test_harness_names_no_model_family(name):
    """The harness reaches the model family only through the arch module
    that a configuration names: it indexes no model's key and imports no
    model of the program and no reference."""
    tree = ast.parse((BENCH / name).read_text(), filename=name)
    keys = {node.slice.value for node in ast.walk(tree)
            if isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)}
    assert not keys & MODEL_KEYS, f"{name} indexes {keys & MODEL_KEYS}"
    bad = [m for m in imported_modules(tree)
           if any(m == p or m.startswith(p + ".") for p in MODEL_IMPORTS)]
    assert not bad, f"{name} imports {bad}"


def test_model_family_check_sees_a_planted_key():
    tree = ast.parse('cfg["unet"]["sample_size"]\n'
                     "from diffusionhandles_tpu_torch.models import unet\n"
                     "from benchmark import reference\n")
    keys = {node.slice.value for node in ast.walk(tree)
            if isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)}
    assert "unet" in keys
    assert {"diffusionhandles_tpu_torch.models",
            "benchmark.reference"} <= set(imported_modules(tree))


def test_harness_loads_no_jax():
    """Importing every harness module leaves no JAX module loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness, benchmark.control, benchmark.counting\n"
        "import benchmark.archs.sd2_depth, benchmark.trace\n"
        "from benchmark.harness import forbidden_modules\n"
        "print(forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
