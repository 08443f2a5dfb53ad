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
import repro_torch.serve.engine, repro_torch.serve.resilience
import repro_torch.serve.faults, repro_torch.obs.metrics
import repro_torch.core.cascade, repro_torch.launch.serve
import torch.profiler
assert {{"repro_torch.core.video", "repro_torch.core.autotune_cache",
         "repro_torch.checkpoint.manager", "repro_torch.data.mining",
         "repro_torch.platform", "repro_torch.launch.detect",
         "repro_torch.serve.engine", "repro_torch.serve.resilience",
         "repro_torch.serve.faults", "repro_torch.obs.metrics",
         "repro_torch.core.cascade", "repro_torch.launch.serve"}} \
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


_SERVE_PROBE = r"""
import sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
from repro_torch.serve.engine import DetectionService
assert not torch.cuda.is_available()
svm = {{"w": np.random.default_rng(0).normal(size=3780).astype(np.float32)
        * .01, "b": np.float32(0.0)}}
try:
    DetectionService(svm)
    raise SystemExit("the default device fell back to the CPU")
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
svc = DetectionService(svm, device="cpu", frame_batch=2).start()
rng = np.random.default_rng(1)
frames = [rng.integers(0, 256, (160, 128, 3)).astype(np.uint8)
          for _ in range(3)]
res = svc.detect_frames(frames, timeout=120)
win = svc.detect([rng.integers(0, 256, (130, 66, 3)).astype(np.uint8)
                  for _ in range(3)], timeout=120)
svc.stop()
assert all("error" not in r and r["degraded_mode"] == "full" for r in res)
assert all(w["human"] in (0, 1) and np.isfinite(w["score"]) for w in win)
print(svc.device.type, svc.stats["frames"], svc.stats["requests"],
      sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                          "repro")))
"""


def test_cpu_service_answers_on_a_host_without_a_gpu():
    """A DetectionService on device="cpu" answers frame and window
    requests with every GPU hidden, importing neither JAX nor the
    reference package; without device="cpu" it refuses to start."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c",
                          _SERVE_PROBE.format(src=str(ROOT / "src"))],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "cpu 3 3 []", out.stdout
