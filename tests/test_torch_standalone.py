"""The port stands alone: neither JAX nor the JAX package is ever loaded
by ``raymarching_tpu_torch`` or ``chip_smoke.py``: checked at run time in a
fresh interpreter and by a scan of the sources."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu_torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "raymarching_tpu_torch"
FOREIGN = ("jax", "jaxlib", "raymarching_tpu")
# what a fresh interpreter prints last: the foreign modules it has loaded
REPORT = ("import sys; print(sorted(m for m in sys.modules "
          f"if m.split('.')[0] in {FOREIGN!r}))")


def _submodules():
    """Every module of the package but ``__main__``, which runs the CLI on
    import (test_module_entry_point_runs drives it)."""
    return sorted(m.name for m in pkgutil.walk_packages(
        raymarching_tpu_torch.__path__, "raymarching_tpu_torch.")
        if not m.name.endswith(".__main__"))


def _fresh(code: str, *argv) -> str:
    out = subprocess.run([sys.executable, "-c", code + "\n" + REPORT, *argv],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_package_has_its_own_copies():
    names = _submodules()
    for want in ("config", "scene.compile", "scene.parser", "scene.csg",
                 "scene.objects", "scene.generators", "scene.writer",
                 "io.image", "io.png", "io.jpeg", "io.checkpoint",
                 "utils.structlog", "utils.timing", "ops.march_kernel",
                 "ops.shade_kernel", "ops.march_op", "ops.normal_op",
                 "io.gif", "io.mesh", "utils.debug", "utils.selfcheck",
                 "parallel.distributed", "parallel.sharded"):
        assert f"raymarching_tpu_torch.{want}" in names


def test_importing_every_submodule_loads_nothing_foreign():
    code = "import importlib\n" + "\n".join(
        f"importlib.import_module({m!r})" for m in _submodules())
    assert _fresh("import raymarching_tpu_torch\n" + code) == "[]"


def test_importing_every_submodule_forms_no_process_group():
    """Importing every module, ``parallel`` included, joins no
    ``torch.distributed`` process group (only ``parallel.distributed
    .initialize`` and a mesh do)."""
    code = "import importlib\n" + "\n".join(
        f"importlib.import_module({m!r})" for m in _submodules())
    code += ("\nimport torch.distributed as dist\n"
             "assert 'raymarching_tpu_torch.parallel.sharded' in sys.modules\n"
             "assert not dist.is_initialized()")
    assert _fresh("import sys\nimport raymarching_tpu_torch\n" + code) == "[]"


def test_cli_run_loads_nothing_foreign(tmp_path):
    out = tmp_path / "o.png"
    code = ("import sys\n"
            "from raymarching_tpu_torch.cli import main\n"
            "assert main(sys.argv[1:]) == 0")
    assert _fresh(code, "--scene", "scenes/config1.txt", "--out", str(out),
                  "--device", "cpu", "--width", "16", "--height", "12",
                  "--ssaa", "1", "--iterations", "60", "--backend",
                  "multi,cuda") == "[]"
    assert out.exists()


def test_module_entry_point_runs(tmp_path):
    out = tmp_path / "m.png"
    res = subprocess.run(
        [sys.executable, "-m", "raymarching_tpu_torch", "--scene",
         "scenes/config1.txt", "--out", str(out), "--device", "cpu",
         "--width", "8", "--height", "6", "--ssaa", "1", "--iterations",
         "40"], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr
    assert out.exists()


@pytest.mark.parametrize("backend", ["cuda", "multi"])
def test_fit_step_with_logging_loads_nothing_foreign(backend):
    code = "\n".join([
        "import io, json",
        "import raymarching_tpu_torch as rt",
        "from raymarching_tpu_torch.utils import structlog",
        "buf = io.StringIO()",
        "structlog.configure(stream=buf, rank=3)",
        "plan, tables = rt.compile_scene(rt.load_scene('scenes/config1.txt'))",
        "cfg = rt.RenderConfig(width=8, height=6, ssaa=1, iterations=40)",
        "target = rt.render_tables(plan, tables, cfg, device='cpu')",
        f"rt.fit(plan, tables, target, cfg, device='cpu', steps=1,"
        f" backend={backend!r}, trainable=('prim_color', 'prim_pos'))",
        "events = [json.loads(ln) for ln in buf.getvalue().splitlines()]",
        "assert [(e['event'], e['process']) for e in events] == "
        "[('fit_step', 3)], events",
    ])
    assert _fresh(code) == "[]"


def _imports(path: Path):
    """Top-level names of every absolute import in a source file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_sources_import_nothing_foreign():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        bad = sorted(set(_imports(path)) & set(FOREIGN))
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_kernel_source_is_registered():
    """ops.build.SOURCES names every csrc/*.cu (each is one library, all
    built together by build_all and by chip_smoke.py), and nothing
    else."""
    from raymarching_tpu_torch.ops import build
    assert sorted(build.SOURCES) == sorted(
        f.stem for f in (PKG / "csrc").glob("*.cu"))
