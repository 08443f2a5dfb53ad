"""The port stands alone: importing every repro_torch module, and what
chip_smoke.py imports, loads neither JAX nor the reference package."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke                     # its top level, then what it runs
import repro_torch.api, repro_torch.core.detector, repro_torch.core.stages
import repro_torch.data.synth_pedestrian, repro_torch.kernels.build
import repro_torch.core.video, repro_torch.core.autotune_cache
import repro_torch.checkpoint.manager, repro_torch.data.mining
import repro_torch.platform, repro_torch.launch.detect
import torch.profiler
assert {{"repro_torch.core.video", "repro_torch.core.autotune_cache",
         "repro_torch.checkpoint.manager", "repro_torch.data.mining",
         "repro_torch.platform", "repro_torch.launch.detect"}} \
    <= set(names), names
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run(
        [sys.executable, "-c",
         _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20, out.stdout          # every module was imported
    assert bad == "[]", bad


def test_batch_and_video_modules_stand_alone():
    """The batched path's and tracked clips' modules, imported on their
    own, load neither JAX nor the reference package, and the autotune
    cache keeps its own default file."""
    probe = ("import sys; sys.path.insert(0, {src!r}); "
             "import repro_torch.core.video as v, "
             "repro_torch.core.autotune_cache as c, "
             "repro_torch.api.session as s; "
             "import os; os.environ.pop('REPRO_AUTOTUNE_CACHE', None); "
             "print(c.cache_path().split(os.sep)[-2], sorted(m for m in "
             "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
             "'repro')))")
    out = subprocess.run([sys.executable, "-c",
                          probe.format(src=str(ROOT / "src"))],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "repro_torch []", out.stdout


def test_training_and_checkpoint_modules_stand_alone():
    """Training, mining, checkpoints, the platform snapshot and the detect
    CLI, imported on their own, load neither JAX nor the reference
    package, and the CLI's --help runs without either."""
    probe = ("import sys; sys.path.insert(0, {src!r}); "
             "import repro_torch.core.svm, repro_torch.data.mining, "
             "repro_torch.checkpoint.manager, repro_torch.platform as p, "
             "repro_torch.launch.detect; "
             "print(p.default_seed({{'REPRO_SEED': '7'}}), sorted(m for m "
             "in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
             "'repro')))")
    out = subprocess.run([sys.executable, "-c",
                          probe.format(src=str(ROOT / "src"))],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "7 []", out.stdout
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.detect",
                          "--help"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0 and "--device" in out.stdout, out.stderr


def test_port_sources_name_no_reference_import():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_)"
                         r"|from repro\b(?!_))", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_configs_import_no_model_or_kernel():
    """The LM configs sit below the model: importing repro_torch.configs
    loads neither the model nor a kernel wrapper."""
    probe = ("import sys; sys.path.insert(0, {src!r}); "
             "import repro_torch.configs; "
             "print(sorted(m for m in sys.modules if m.startswith("
             "('repro_torch.models.model', 'repro_torch.models.attention', "
             "'repro_torch.kernels'))))")
    out = subprocess.run([sys.executable, "-c",
                          probe.format(src=str(ROOT / "src"))],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
