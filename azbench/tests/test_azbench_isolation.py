"""The benchmark loads neither JAX nor the JAX package, and its reference
imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "alphazero_tpu"}


def test_harness_and_drivers_load_no_jax():
    """Import the harness, every driver, metric reader, reference family
    and what the drivers import of the program in a fresh process: no
    loaded module's top-level name is JAX's or the JAX package's."""
    code = (
        "import sys\n"
        "from azbench import run, harness, trace, check, counts, spec\n"
        "import azbench.drivers.selfplay, azbench.drivers.play\n"
        "import alphazero_tpu_torch.training.loop\n"
        "import alphazero_tpu_torch.eval.play\n"
        "import alphazero_tpu_torch.search.mcts\n"
        "import alphazero_tpu_torch.search.fused\n"
        "for p in sorted((spec.HERE / 'metrics').glob('*.py')):\n"
        "    spec.reader(p.stem)\n"
        "from azbench.reference import nets\n"
        "for p in sorted(nets.FAMILIES.glob('*.py')):\n"
        "    nets.family(p.stem)\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole():
    from azbench import run
    sys.modules.setdefault("alphazero_tpu_torch_fake_probe", sys)
    try:
        assert "alphazero_tpu_torch_fake_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["alphazero_tpu_torch_fake_probe"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    [*(HERE / "reference").rglob("*.py"), HERE / "counts.py",
     HERE / "check.py", HERE / "weights.py"]), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & (FORBIDDEN | {"alphazero_tpu_torch"})
