"""Houdini frame saver — the reference's houdini_file_saver.

Mirrors ``libclsph/file_save_delegates/houdini_file_saver.{h,cpp}``:
frames named ``<prefix>frames/frameNNNNNNN.geo`` with the reference's
quirky zero-pad rule (pad to 9, keep last 7 — houdini_file_saver.cpp:
15-23), density -> RGB colour ramp (:46-60), and the optional binary
``.bgeo`` path (:78-88).
"""

from __future__ import annotations

import os

import numpy as np

from ..core.params import SimulationParameters
from . import bgeo as bgeo_mod
from . import geo_format

OUTPUT_FILE_NAME = "frames/frame"  # houdini_file_saver.cpp:12


def zero_pad_number(num: int) -> str:
    """Pad to width 9 then keep the last 7 chars
    (houdini_file_saver.cpp:15-23)."""
    s = "%09d" % num
    if len(s) > 7:
        s = s[-7:]
    return s


class HoudiniFileSaver:
    """Callable frame saver with the reference's constructor signature
    (houdini_file_saver.h:10-14)."""

    def __init__(self, frames_folder_prefix: str, use_partio: bool = False):
        self.frames_folder_prefix = frames_folder_prefix
        self.frame_count = 0
        self.use_partio = use_partio
        if not use_partio and geo_format.native_writer() is None:
            import logging

            logging.getLogger(__name__).warning(
                ".geo export using the pure-NumPy serializer — ~10x "
                "slower and it gates the frame loop via the async "
                "saver's join. The native writer (native/geo_writer.cpp, "
                "built by libclsph_tpu_torch.io.native into "
                "build/libclsph_tpu_torch/native/) did not build; "
                "geo_format.native_writer(required=True) shows why"
            )

    def write_frame_to_file(
        self, arrays: dict, parameters: SimulationParameters
    ) -> int:
        """``arrays``: host dict with position/velocity/density."""
        self.frame_count += 1
        ext = ".bgeo" if self.use_partio else ".geo"
        file_name = (
            self.frames_folder_prefix
            + OUTPUT_FILE_NAME
            + zero_pad_number(self.frame_count)
            + ext
        )
        os.makedirs(os.path.dirname(file_name) or ".", exist_ok=True)

        position = np.asarray(arrays["position"], dtype=np.float32)
        velocity = np.asarray(arrays["velocity"], dtype=np.float32)
        color = geo_format.density_color_ramp(arrays["density"])

        if self.use_partio:
            with open(file_name, "wb") as f:
                bgeo_mod.dump_bgeo(
                    f,
                    position,
                    velocity,
                    color,
                    parameters.particle_mass,
                    parameters.h,
                )
        else:
            geo_format.write_geo_file(
                file_name, position, velocity, color, parameters.particle_mass
            )
        return 0

    # snake_case is idiomatic here; keep the reference's exact method
    # name as an alias for drop-in familiarity (houdini_file_saver.h:13)
    writeFrameToFile = write_frame_to_file
