"""libclsph-tpu's PyTorch port: the SPH main path and the deep-column
path (pretune, two-tier routing, q-granular tables) on one NVIDIA GPU.

A second package beside ``libclsph_tpu`` (the JAX reference, which this
package never imports). Plain tensor code is PyTorch; the density and
force passes are hand-written CUDA kernels for Hopper
(``csrc/``), built at their first launch. On CPU tensors every kernel
wrapper runs its plain PyTorch version instead, which is how the tests
hold the port against the JAX package.
"""

__version__ = "0.1.0"
