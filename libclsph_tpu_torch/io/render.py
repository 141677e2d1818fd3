"""On-device point rendering: the engine's live view without a rasteriser.

PyTorch counterpart of ``libclsph_tpu/io/render.py``. The reference
draws density-coloured GL points with a rotating camera
(``example/opengl.cpp:121-148``, ``shaders/vert.glsl:1-18``); here the
projection, the colour ramp and the depth test run as tensor ops on the
particles' device, and only the finished image is copied to the host
(about 1.9 MB a frame at 900 x 700, against 12 MB of state at 1M
particles):

1. orbit camera and perspective projection (the reference's rotating
   MVP, opengl.cpp:108-117);
2. density -> RGB by the export colour ramp
   (houdini_file_saver.cpp:46-60, ``io/geo_format.density_color_ramp``);
3. z-buffered point splats by one scatter-min a splat offset: each
   point packs (quantised depth << 18 | r6 g6 b6) into one int32 key, so
   the minimum keeps the nearest point's colour. Points behind the
   camera, outside the frame or at non-finite or far (sentinel)
   coordinates fail the float validity test and go to a dropped slot.

Same image as the JAX package's for the same inputs, up to the rounding
of the camera's trigonometry and of the centroid's sum.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np
import torch

# packed-key layout: [ z:13 | r:6 | g:6 | b:6 ] = 31 bits (int32-safe)
_ZBITS = 13
_CBITS = 6
_ZMAX = (1 << _ZBITS) - 1
_CMAX = (1 << _CBITS) - 1
_EMPTY = 0x7FFFFFFF  # above any packed key
_ZNEAR = 0.05


def density_ramp(density: torch.Tensor) -> torch.Tensor:
    """density -> (n, 3) float32 RGB, the export ramp of
    ``io/geo_format.density_color_ramp`` (houdini_file_saver.cpp:46-60)."""
    d = density.to(torch.float32)
    zero = torch.zeros_like(d)
    r = torch.where((d > 1000.0) & (d <= 2000.0), (d - 1000.0) / 1000.0, zero)
    g = torch.where((d >= 0.0) & (d < 1000.0), 1.0 - d / 1000.0, zero)
    b = torch.where(
        (d >= 500.0) & (d <= 1000.0),
        (d - 500.0) / 500.0,
        torch.where((d >= 1000.0) & (d <= 1500.0), 1.0 - (d - 1000.0) / 500.0, zero),
    )
    return torch.stack([r, g, b], dim=1)


def _scalar(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def render_points(position: torch.Tensor, density: torch.Tensor, yaw, pitch, zoom, center,
                  *, width: int = 900, height: int = 700, splat: int = 2,
                  focal: float = 0.9,
                  background: Sequence[int] = (18, 18, 24)) -> torch.Tensor:
    """Render density-coloured points to a (height, width, 3) uint8 image
    on ``position``'s device.

    ``position`` (n, 3) world positions (rows at non-finite or far
    coordinates are culled by the frustum test); ``density`` (n,);
    ``yaw``/``pitch``/``zoom`` the orbit camera (floats or 0-d tensors),
    ``center`` (3,) its target; ``splat`` the square splat size in
    pixels."""
    dev = position.device
    yaw, pitch, zoom = (_scalar(v, dev) for v in (yaw, pitch, zoom))
    center = _scalar(center, dev)
    # orbit camera: yaw about y, pitch about x, then push back by zoom
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    p = position.to(torch.float32) - center
    x = cy * p[:, 0] + sy * p[:, 2]
    z0 = -sy * p[:, 0] + cy * p[:, 2]
    y = cp * p[:, 1] - sp * z0
    z = sp * p[:, 1] + cp * z0 + zoom

    f = focal * height
    vis = z > _ZNEAR
    zsafe = torch.where(vis, z, 1.0)
    fx = f * x / zsafe + width / 2.0
    fy = height / 2.0 - f * y / zsafe
    # validity decided on floats: NaN/Inf coordinates fail every
    # comparison, so sentinel rows never reach the cast below
    ok = (vis & (fx >= 0.0) & (fx <= float(width - splat)) & (fy >= 0.0)
          & (fy <= float(height - splat)))
    xi = torch.clamp(fx, 0.0, width - 1.0).to(torch.int64)
    yi = torch.clamp(fy, 0.0, height - 1.0).to(torch.int64)

    # depth quantised over [ZNEAR, zfar]; zfar follows the visible extent
    zfar = torch.clamp(torch.amax(torch.where(ok, z, _ZNEAR)), min=_ZNEAR + 1e-3)
    zq = (torch.clamp((z - _ZNEAR) / (zfar - _ZNEAR), 0.0, 1.0) * _ZMAX).to(torch.int32)

    rgb = torch.clamp(density_ramp(density), 0.0, 1.0)
    c6 = (rgb * _CMAX + 0.5).to(torch.int32)  # (n, 3) 6-bit channels
    key = (zq << (3 * _CBITS)) | (c6[:, 0] << (2 * _CBITS)) | (c6[:, 1] << _CBITS) | c6[:, 2]

    npix = width * height
    pix = yi * width + xi
    buf = torch.full((npix + 1,), _EMPTY, dtype=torch.int32, device=dev)  # last: dropped
    for dy in range(splat):
        for dx in range(splat):
            idx = torch.where(ok, pix + (dy * width + dx), npix)
            buf.scatter_reduce_(0, idx, key, reduce="amin")
    buf = buf[:npix]

    hit = buf != _EMPTY
    chan = torch.stack([(buf >> (2 * _CBITS)) & _CMAX, (buf >> _CBITS) & _CMAX,
                        buf & _CMAX], dim=-1)
    fg = (chan.to(torch.float32) * (255.0 / _CMAX) + 0.5).to(torch.uint8)
    bg = torch.as_tensor(list(background), dtype=torch.uint8, device=dev)
    img = torch.where(hit[:, None], fg, bg[None, :])
    return img.reshape(height, width, 3)


class PointRenderer:
    """Camera state and the render: the engine's ``device_view`` target
    (:meth:`view`), or called with (position, density) tensors or NumPy
    arrays (NumPy arrays render on the CPU)."""

    def __init__(self, width: int = 900, height: int = 700, splat: int = 2):
        self.width = width
        self.height = height
        self.splat = splat
        self.yaw = 0.6
        self.pitch = 0.35
        self.zoom = 3.0
        self.auto_rotate = True
        self.center = None  # default: the live particles' centroid

    def render(self, position, density) -> np.ndarray:
        """(H, W, 3) uint8 host image of the given particle state, rendered
        on its device: one copy of the image to the host."""
        if self.auto_rotate:
            self.yaw += 0.02  # the reference's rotating camera
        position = torch.as_tensor(position)
        density = torch.as_tensor(density)
        if self.center is None:
            live = torch.abs(position) < 1.0e30
            center = torch.nanmean(torch.where(live, position, float("nan")), dim=0)
        else:
            center = self.center
        return render_points(position, density, np.float32(self.yaw),
                             np.float32(self.pitch), np.float32(self.zoom), center,
                             width=self.width, height=self.height,
                             splat=self.splat).cpu().numpy()

    def view(self, state, params, is_full_frame: bool) -> None:
        """The engine's ``device_view`` signature; set ``on_image`` (or
        subclass) to consume the frame."""
        self.on_image(self.render(state.position, state.density))

    def on_image(self, image: np.ndarray) -> None:  # pragma: no cover
        raise NotImplementedError("assign on_image or subclass PointRenderer")


def write_png(path, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG with the
    standard library alone (zlib, struct): no image package needed."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8 images, not {img.shape}")
    # filter type 0 (none) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))
