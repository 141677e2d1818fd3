"""The substep's advection, collision response and next time step: the
CUDA kernel, its plain PyTorch version and the wrapper that picks between
them by device.

:func:`advect_collide` is one advance of the substep
(``engine/step.py: _advect_collide``): the leapfrog update
(:func:`ops.integrate.advect`), the distance-field response of the scene
(:func:`ops.collisions.handle_collisions`), the half-step velocity
reconstruction (:func:`ops.integrate.reconstruct_velocities`) and, with
``time_step``, the next dt from the new velocities and the accelerations
(:func:`ops.integrate.compute_time_step`). The plain version,
:func:`advect_collide_torch`, is that chain; on the card it is about 280
launches an advance. ``csrc/advect_collide.cu`` is one launch, with the
same float32 roundings, and keeps dt on the device: it reads ``dt`` from
the device and writes ``dt_next`` there (the block that finishes last
forms it from the maxima that all blocks fold into a device scratch).
It replaces no TPU kernel: the JAX package leaves this stage to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.params import SimulationParameters
from ...utils import profiling
from .. import collisions, integrate
from . import build

# (device, stream) -> the kernel's 3-word maxima scratch, zero between launches
_scratch: dict = {}


def advect_collide_torch(position, intermediate_velocity, acceleration, dt,
                         scene: Optional[collisions.DeviceScene],
                         params: SimulationParameters, time_step: bool = True):
    """Plain PyTorch version of :func:`advect_collide`."""
    adv = integrate.advect(position, intermediate_velocity, acceleration, dt)
    resp = collisions.handle_collisions(scene, adv.old_position, adv.new_position,
                                        adv.next_velocity, params.restitution, dt)
    velocity, intermediate = integrate.reconstruct_velocities(intermediate_velocity,
                                                              resp.next_velocity)
    dt_next = (integrate.compute_time_step(velocity, acceleration, params)
               if time_step else None)
    return resp.position, velocity, intermediate, dt_next


def _check(position, intermediate_velocity, acceleration, dt, scene):
    n = position.shape[0] if position.dim() == 2 else -1
    named = (("position", position), ("intermediate_velocity", intermediate_velocity),
             ("acceleration", acceleration))
    for name, t in named:
        if t.dtype != torch.float32 or t.shape != (n, 3):
            raise ValueError(f"{name} must be (n, 3) float32 like position, not "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != position.device:
            raise ValueError(f"{name} is on {t.device}, position on {position.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if position.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {position.device}")
    if position.device.type == "cpu":
        return
    if not (torch.is_tensor(dt) and dt.dtype == torch.float32 and dt.numel() == 1
            and dt.device == position.device):
        raise ValueError("dt must be one float32 on the particles' device")
    if scene is None:
        return
    for name, dtype in (("bb_min", torch.float32), ("bb_max", torch.float32),
                        ("bb_size", torch.int32), ("bb_offset", torch.int32),
                        ("corner8", torch.float32)):
        t = getattr(scene, name)
        if t.dtype != dtype or t.device != position.device or not t.is_contiguous():
            raise ValueError(f"scene.{name} must be contiguous {dtype} on {position.device}")
    if scene.corner8.dim() != 2 or scene.corner8.shape[1] != 8 or scene.corner8.data_ptr() % 16:
        raise ValueError("scene.corner8 must be (G, 8), 16-byte aligned")


def advect_collide(position, intermediate_velocity, acceleration, dt,
                   scene: Optional[collisions.DeviceScene], params: SimulationParameters,
                   time_step: bool = True):
    """One advance by ``dt`` (a 0-d float32 tensor) of particles
    (position, intermediate_velocity, acceleration), each (n, 3) float32
    and contiguous, against ``scene`` (None: free flight). Returns
    (position, velocity, intermediate_velocity, dt_next): ``dt_next`` the
    0-d float32 next time step with ``time_step``, else None. CPU tensors
    take the plain version; CUDA tensors launch the kernel (building it at
    first use), each launch counted, or raise."""
    _check(position, intermediate_velocity, acceleration, dt, scene)
    if position.device.type == "cpu":
        return advect_collide_torch(position, intermediate_velocity, acceleration, dt, scene,
                                    params, time_step)
    dev = position.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = [torch.empty_like(position) for _ in range(3)]
    dt_next = scratch = None
    if time_step:
        dt_next = torch.empty((), dtype=torch.float32, device=dev)
        scratch = _scratch.get((dev, stream))
        if scratch is None:
            scratch = _scratch[dev, stream] = torch.zeros(3, dtype=torch.int32, device=dev)
    faces = 0 if scene is None else scene.face_count
    tables = ((None,) * 5 if scene is None else
              tuple(t.data_ptr() for t in (scene.bb_min, scene.bb_max, scene.bb_size,
                                           scene.bb_offset, scene.corner8)))
    status = build.load_library().advect_collide_launch(
        position.data_ptr(), intermediate_velocity.data_ptr(), acceleration.data_ptr(),
        dt.data_ptr(), position.shape[0], *tables, faces, params.restitution, params.h,
        integrate.DT_MIN, params.max_dt, *(t.data_ptr() for t in out),
        None if dt_next is None else dt_next.data_ptr(),
        None if scratch is None else scratch.data_ptr(), stream)
    build.check(status, "advect_collide")
    advect_collide.launches += 1
    profiling.count("advect.kernel")
    return out[0], out[1], out[2], dt_next


advect_collide.launches = 0
