"""The port must run where JAX is absent: nothing under mcpt_tpu_torch/,
and not chip_smoke.py or time_closest_batch.py, imports jax, jaxlib or mcpt_tpu, and importing the
package builds no kernel."""
import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "mcpt_tpu"}


def _port_files():
    files = sorted(glob.glob(os.path.join(ROOT, "mcpt_tpu_torch", "**", "*.py"), recursive=True))
    return files + [os.path.join(ROOT, f) for f in ("chip_smoke.py", "time_closest_batch.py")]


def test_scan_covers_the_treelet_modules():
    """The scan above covers the treelet layout, the schedule and select
    routes and the loader of csrc/treelet.cu (ops/_build.py), and the loader
    binds all four of its kernels."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in ("treelets", "schedule", "select", "_build"):
        assert f"mcpt_tpu_torch/ops/{name}.py" in rel
    from mcpt_tpu_torch.ops import _build

    assert os.path.join(_build.CSRC_DIR, "treelet.cu") in _build.sources()
    for kernel in ("schedule_closest", "schedule_any", "select_closest", "select_any"):
        assert kernel in _build.SIGNATURES


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_renders_with_jax_blocked():
    """Import the port and render cornell at 16x16 on the CPU with jax,
    jaxlib and mcpt_tpu made unimportable."""
    out = _run(
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'mcpt_tpu'): sys.modules[m] = None\n"
        "from mcpt_tpu_torch.io.obj import load_scene\n"
        "from mcpt_tpu_torch.render.renderer import Renderer, RenderConfig\n"
        "s = load_scene('scenes/cornell-box.obj', device='cpu')\n"
        "r = Renderer(s, RenderConfig(max_bounces=3, width=16, height=16))\n"
        "r.step()\n"
        "assert r.stats['nan_scrubbed'] == 0 and float(r.film.accum.mean()) > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mcpt_tpu') and sys.modules[m] is not None]\n"
        "print('OK', bad)\n"
    )
    assert out.strip() == "OK []"


def test_select_route_renders_with_jax_blocked():
    """A 5,986-triangle stress scene (above 4,096: the treelet layout is
    built) rendered at 16x12 on the CPU through the select route
    (MCPT_TREELET_SELECT=smem), with jax, jaxlib and mcpt_tpu unimportable."""
    out = _run(
        "import os, sys\n"
        "os.environ['MCPT_TREELET_SELECT'] = 'smem'\n"
        "for m in ('jax', 'jaxlib', 'mcpt_tpu'): sys.modules[m] = None\n"
        "import chip_smoke\n"
        "from mcpt_tpu_torch.ops import select\n"
        "from mcpt_tpu_torch.render.renderer import Renderer, RenderConfig\n"
        "(s,) = chip_smoke.stress_scene(6000, 0, ('cpu',))\n"
        "r = Renderer(s, RenderConfig(max_bounces=2, width=16, height=12))\n"
        "r.step()\n"
        "assert s.treelets is not None and select.PLAIN_CALLS['closest'] > 0\n"
        "assert r.stats['nan_scrubbed'] == 0 and float(r.film.accum.mean()) > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mcpt_tpu') and sys.modules[m] is not None]\n"
        "print('OK', bad)\n"
    )
    assert out.strip() == "OK []"


def test_import_builds_nothing():
    """Importing every module of the package runs no compiler (nvcc or g++)
    and loads no library."""
    out = _run(
        "import importlib, pkgutil, subprocess\n"
        "def refuse(*a, **k): raise AssertionError('subprocess started at import')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "import mcpt_tpu_torch\n"
        "for m in pkgutil.walk_packages(mcpt_tpu_torch.__path__, 'mcpt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from mcpt_tpu_torch.ops import _build\n"
        "print('OK', _build._lib is None, _build.last_build == {}, _build._host_lib is None,\n"
        "      _build.last_host_build == {})\n"
    )
    assert out.strip() == "OK True True True True"
