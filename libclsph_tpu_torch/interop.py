"""Carry data between the JAX package and the port.

Both directions go through NumPy, so this module imports neither JAX
nor ``libclsph_tpu``: JAX-side objects are read by field name with
``np.asarray``, which accepts JAX arrays.

* JAX -> port: :func:`state_from_arrays` (``ParticleState``;
  ``grid_index`` uint32 -> int32), :func:`scene_from_arrays`
  (``DeviceScene`` with ``df`` and ``corner8``) and
  :func:`params_from` (``SimulationParameters``).
* port -> NumPy: :func:`state_to_numpy` (``grid_index`` back to
  uint32, as the JAX package holds it) and :func:`to_numpy`.
* :func:`step_config_from_jax`: a JAX ``StepConfig`` -> the port's, over
  the fields both have, so one configuration drives both packages.
* :func:`split_for_mesh`: a JAX state padded and Morton-partitioned by
  ``pad_for_mesh`` -> the host arrays of each rank's rows, which
  :func:`parallel.mesh.launch` hands to the port's ranks, so both
  packages run the same rows on the same shards.

The state conversions are the checkpoint's, whose file format is the
JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.params import SimulationParameters
from .core.state import FIELDS, ParticleState
from .engine.step import StepConfig
from .io.checkpoint import arrays_to_state
from .io.checkpoint import state_to_arrays as state_to_numpy
from .ops.collisions import DeviceScene

__all__ = ["to_numpy", "state_from_arrays", "state_to_numpy", "scene_from_arrays",
           "params_from", "step_config_from_jax", "split_for_mesh"]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def state_from_arrays(state, device) -> ParticleState:
    """A JAX ``ParticleState`` (or anything with its field attributes,
    or a dict of them) -> the port's state on ``device``."""
    if not isinstance(state, dict):
        state = {k: getattr(state, k) for k in FIELDS}
    return arrays_to_state(state, device)


def scene_from_arrays(scene, device) -> DeviceScene | None:
    """A JAX ``DeviceScene`` -> the port's, on ``device``."""
    if scene is None:
        return None
    ints = ("bb_size", "bb_offset")
    return DeviceScene(**{
        k: torch.as_tensor(
            np.array(getattr(scene, k), dtype=np.int32 if k in ints else np.float32),
            device=device,
        )
        for k in DeviceScene._fields
    })


def params_from(params) -> SimulationParameters:
    """The JAX package's ``SimulationParameters`` (any object with the
    same field names) -> the port's."""
    return SimulationParameters(**{
        f.name: getattr(params, f.name) for f in dataclasses.fields(SimulationParameters)
    })


def step_config_from_jax(cfg) -> StepConfig:
    """The JAX package's ``StepConfig`` (any object with its field names)
    -> the port's, over the fields both have. The port's refusals apply."""
    return StepConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(StepConfig) if hasattr(cfg, f.name)
    })


def split_for_mesh(state, n_shards: int) -> list:
    """A state already padded and partitioned over ``n_shards`` (JAX's
    ``pad_for_mesh``, or the port's) -> per rank, the host arrays of its
    contiguous rows (``io.checkpoint``'s layout, ``grid_index`` uint32)."""
    if not isinstance(state, dict):
        state = {k: getattr(state, k) for k in FIELDS}
    arrays = {k: np.asarray(state[k]) for k in FIELDS}
    n = arrays["position"].shape[0]
    if n % n_shards:
        raise ValueError(f"{n} rows do not split over {n_shards} shards")
    rows = n // n_shards
    return [{k: np.array(v[r * rows:(r + 1) * rows]) for k, v in arrays.items()}
            for r in range(n_shards)]
