"""The port's top-level API: the names of the JAX package's ``__all__``
(``libclsph_tpu/__init__.py:27-44``), with ``substep`` and ``frame``
standing in for ``substep_jit`` and ``frame_jit``, each the object of
its submodule; and an import that loads neither JAX nor the JAX package
and initialises no CUDA device."""

import os
import subprocess
import sys

import libclsph_tpu
import libclsph_tpu_torch
from libclsph_tpu_torch.core import params, state
from libclsph_tpu_torch.engine import simulation, step
from libclsph_tpu_torch.io import houdini
from libclsph_tpu_torch.models import presets
from libclsph_tpu_torch.scene import scene
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAND_INS = {"substep_jit": "substep", "frame_jit": "frame"}
HOMES = {
    "PrecomputedKernelValues": params, "SimulationParameters": params,
    "derive_parameters": params, "load_parameters": params,
    "ParticleState": state, "init_state": state,
    "SPHSimulation": simulation, "StepConfig": step, "substep": step, "frame": step,
    "HoudiniFileSaver": houdini, "PRESETS": presets, "Preset": presets,
    "get_preset": presets, "Scene": scene,
}


def test_all_matches_the_jax_package():
    want = [STAND_INS.get(name, name) for name in libclsph_tpu.__all__]
    assert libclsph_tpu_torch.__all__ == want
    for name in want:
        obj = getattr(libclsph_tpu_torch, name)
        if name == "__version__":
            assert obj == libclsph_tpu.__version__
        else:
            assert obj is getattr(HOMES[name], name), name


def test_import_loads_no_jax_and_no_cuda():
    code = ("import sys, torch, libclsph_tpu_torch\n"
            "from libclsph_tpu_torch import (SPHSimulation, StepConfig, substep, frame,\n"
            "    Scene, get_preset, HoudiniFileSaver)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'libclsph_tpu' or m.startswith('libclsph_tpu.'))\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_initialized()\n"
            "from libclsph_tpu_torch.ops.kernels import build\n"
            "assert build._library is None, 'a kernel library was loaded'\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
