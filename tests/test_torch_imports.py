"""Import hygiene of the port, and no silent fallback.

Every module of ``repro_torch``, the serving front end
``repro_torch.serve``, ``repro_torch.memtier``, ``repro_torch.models``,
``repro_torch.configs``, ``repro_torch.launch`` (``launch.mesh`` and the
collectives of ``repro_torch.dist`` too), the simulator baselines
``repro_torch.sims``, the production meshes' dry run
``repro_torch.launch.dryrun`` and the port's reprolint
``repro_torch.analysis`` (all eight passes) included (and the card
scripts ``chip_smoke.py``, ``chip_faults.py``, ``chip_compare_off.py``
and ``chip_mesh_f32.py``, and the port's
examples ``examples/*_torch.py``) imports with ``jax`` and ``repro`` made
unimportable; ``chip_smoke.py`` exits nonzero
and prints no result where there is no CUDA device, or when it stands
alone without the repository.
"""
import importlib.util
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, "src")
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
for script in ("chip_smoke", "chip_faults", "chip_compare_off",
               "chip_mesh_f32"):
    spec = importlib.util.spec_from_file_location(script, script + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro."))
       or m == "repro"]
bad = [m for m in bad if sys.modules[m] is not None]
assert not bad, bad
print(" ".join(names))
"""

# The serving front end (``repro_torch.serve``) is part of the port.
_SERVE = ("repro_torch.serve", "repro_torch.serve.buckets",
          "repro_torch.serve.kv", "repro_torch.serve.contracts",
          "repro_torch.serve.staging", "repro_torch.serve.scheduler")


# The tiered KV-cache accounting (``repro_torch.memtier``) too.
_MEMTIER = ("repro_torch.memtier", "repro_torch.memtier.tiered_cache")

# The model path (every family), the serving engine over it and its
# launcher.
_MODELS = ("repro_torch.device", "repro_torch.configs",
           "repro_torch.configs.shapes", "repro_torch.configs.minitron_8b",
           "repro_torch.configs.gemma3_4b", "repro_torch.models",
           "repro_torch.models.config", "repro_torch.models.sharding",
           "repro_torch.models.chunked_attention",
           "repro_torch.models.layers", "repro_torch.models.decode",
           "repro_torch.models.transformer", "repro_torch.models.rwkv",
           "repro_torch.models.moe", "repro_torch.models.mla",
           "repro_torch.models.mamba", "repro_torch.memtier.engine",
           "repro_torch.launch", "repro_torch.launch.serve")

# The training path: optimizer, data, checkpoints and the launcher.
_TRAIN = ("repro_torch.optim", "repro_torch.optim.adamw",
          "repro_torch.optim.compress", "repro_torch.data",
          "repro_torch.data.pipeline", "repro_torch.ckpt",
          "repro_torch.ckpt.checkpoint", "repro_torch.launch.steps",
          "repro_torch.launch.train")

# The software-simulator baselines and the port's reprolint.
_SLICE13 = ("repro_torch.sims", "repro_torch.sims.trace_sim",
            "repro_torch.sims.cycle_sim", "repro_torch.analysis",
            "repro_torch.analysis.common", "repro_torch.analysis.lanes",
            "repro_torch.analysis.staticness",
            "repro_torch.analysis.tripwire", "repro_torch.analysis.docrefs",
            "repro_torch.analysis.__main__")

# The multi-device paths: the sweep's mesh and the launcher, the
# collectives, and the specs of training over a mesh.
_MESH = ("repro_torch.launch.mesh", "repro_torch.dist",
         "repro_torch.launch.shardings")

# The last modules: the production meshes' dry run and reprolint's four
# passes restated for PyTorch.
_LAST = ("repro_torch.launch.dryrun", "repro_torch.analysis.schedule",
         "repro_torch.analysis.donation", "repro_torch.analysis.ranges",
         "repro_torch.analysis.kernel_san")

_IMPORT_EXAMPLES = r"""
import importlib.util, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, "src")
sys.path.insert(0, "examples")
names = sys.argv[1:]
for name in names:
    spec = importlib.util.spec_from_file_location(name,
                                                  f"examples/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro."))
       or m == "repro"]
bad = [m for m in bad if sys.modules[m] is not None]
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 20
    assert set(_SERVE) <= set(names)
    assert set(_MEMTIER) <= set(names)
    assert set(_MODELS) <= set(names)
    assert set(_TRAIN) <= set(names)
    assert set(_SLICE13) <= set(names)
    assert set(_MESH) <= set(names)
    assert set(_LAST) <= set(names)


def test_examples_import_without_jax_or_repro():
    """The port's examples with a ``main`` import only ``repro_torch``
    (and each other) and run nothing on import."""
    names = [f"{n}_torch" for n in ("quickstart", "policy_exploration",
                                    "serve_continuous", "wear_leveling",
                                    "endurance_lifetime")]
    out = subprocess.run([sys.executable, "-c", _IMPORT_EXAMPLES, *names],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == names


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _planted_faults():
    spec = importlib.util.spec_from_file_location("chip_faults",
                                                  ROOT / "chip_faults.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FAULTS


FAULTS = _planted_faults()


@pytest.mark.parametrize("i", range(len(FAULTS)))
def test_planted_fault_text_stands_once_in_its_source(i):
    """Each fault of ``chip_faults.py`` replaces text that stands exactly
    once in its source (a CUDA kernel, or the port's serving code), so
    that an edit that moves the text shows here and not first on the
    card."""
    name, kernel, source, text, faulty = FAULTS[i]
    code = (ROOT / source).read_text()
    assert code.count(text) == 1, name
    assert faulty != text and kernel in source, name
