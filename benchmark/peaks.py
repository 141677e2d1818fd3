"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit), and the work the problem needs, counted from
its shapes: the yardstick of the roofline and peak shares."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores, operations a second
HBM_BYTES = 3.35e12  # bytes a second
# float32 operations a pair within h: the density's poly6 term and the
# force pass's pressure, viscosity and colour-field terms
DENSITY_OPS = 16
FORCE_OPS = 51
# bytes a particle: the density pass reads a position and writes a
# density; the force pass reads position, velocity, density and pressure
# and writes an acceleration (float32, each once)
DENSITY_BYTES = 12 + 4
FORCE_BYTES = 12 + 12 + 4 + 4 + 12


def least_seconds(particles: int, pairs: float) -> float:
    """The least time a substep's density and force work could take: the
    larger of its operations over FP32_FLOPS and its bytes over
    HBM_BYTES."""
    ops = pairs * (DENSITY_OPS + FORCE_OPS)
    return max(ops / FP32_FLOPS, particles * (DENSITY_BYTES + FORCE_BYTES) / HBM_BYTES)
