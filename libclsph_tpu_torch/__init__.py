"""libclsph-tpu's PyTorch port: Smoothed Particle Hydrodynamics on NVIDIA
GPUs.

A second package beside ``libclsph_tpu`` (the JAX reference, which this
package never imports) with the same surface: the two-JSON config, the
Morton-sorted substep with the adaptive-dt retry, signed-distance-field
mesh collisions, the frame engine with its callbacks, capacity autotune,
pretune and checkpoint, ``.geo``/``.bgeo`` export, and the ``sph-torch``
CLI. Every neighbour impl and variant of the JAX package runs here
(``StepConfig``: the ``pallas`` impl's nl, asm, row, fine and asym
variants at every block size, query width and refine mode, two-tier
routing, the ``tiles`` impl and the ``exact`` impl with its radix sort,
each r^2 mode: ``pair_r2`` and ``tile_mode``), and so does the Morton-partitioned sharded substep over
``torch.distributed`` (:mod:`parallel`, ``SPHSimulation(mesh=...)``), the
on-device renderer (:mod:`io.render`) and the legacy checkpoint import.

Plain tensor code is PyTorch; the density and force passes and the radix
sort are hand-written CUDA kernels for Hopper (``csrc/``), built at their
first launch, never at import. On CPU tensors every kernel wrapper runs
its plain PyTorch version instead, which is how the tests hold the port
against the JAX package. Importing the package initialises no CUDA
device.

``substep`` and ``frame`` stand in for the JAX package's ``substep_jit``
and ``frame_jit``.
"""

from .core.params import (
    PrecomputedKernelValues,
    SimulationParameters,
    derive_parameters,
    load_parameters,
)
from .core.state import ParticleState, init_state
from .engine.simulation import SPHSimulation
from .engine.step import StepConfig, frame, substep
from .io.houdini import HoudiniFileSaver
from .models.presets import PRESETS, Preset, get_preset
from .scene.scene import Scene

__version__ = "0.1.0"

__all__ = [
    "PrecomputedKernelValues",
    "SimulationParameters",
    "derive_parameters",
    "load_parameters",
    "ParticleState",
    "init_state",
    "SPHSimulation",
    "StepConfig",
    "substep",
    "frame",
    "HoudiniFileSaver",
    "PRESETS",
    "Preset",
    "get_preset",
    "Scene",
    "__version__",
]
