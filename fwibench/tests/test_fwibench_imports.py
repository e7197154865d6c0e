"""Nothing under fwibench/ loads jax, jaxlib, flax or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), and the reference loads nothing of the port."""
import json
import subprocess
import sys

from fwibench.tests.tiny import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "sep2023_tpu")


def _loaded(code: str) -> set:
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_every_module_loads_no_jax():
    code = (
        "import importlib.util, json, pathlib, sys\n"
        "sys.path.insert(0, '.')\n"
        "sys.path.insert(0, 'fwibench')\n"
        "import run, control\n"
        "for p in sorted(pathlib.Path('fwibench').rglob('*.py')):\n"
        "    if 'tests' in p.parts: continue\n"
        "    n = 'm_' + '_'.join(p.with_suffix('').parts).replace('.', '_')\n"
        "    s = importlib.util.spec_from_file_location(n, p)\n"
        "    m = sys.modules[n] = importlib.util.module_from_spec(s)\n"
        "    s.loader.exec_module(m)\n"
        "import fwibench.harness.drive as d\n"
        "from sep2023_tpu_torch import cli, optimize, parallel\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _loaded(code)
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "sep2023_tpu_torch" in top


def test_reference_loads_nothing_of_the_port():
    code = (
        "import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "import fwibench.reference.twin, fwibench.reference.elastic\n"
        "import fwibench.inputs, fwibench.harness.work\n"
        "from fwibench.harness import judge\n"
        "judge.config_module('main001'); judge.config_module('main004')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _loaded(code)
    assert not top & {*FORBIDDEN, "sep2023_tpu_torch"}


def test_run_refuses_without_a_card():
    res = subprocess.run(
        [sys.executable, "fwibench/run.py", "--workload", "main001-forward",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
