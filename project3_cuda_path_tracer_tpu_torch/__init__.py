"""project3_cuda_path_tracer_tpu_torch: the path tracer ported to
PyTorch and CUDA (NVIDIA Hopper).

It mirrors the layout of the JAX package `project3_cuda_path_tracer_tpu`,
which stays the reference; this package imports neither that package
nor JAX. On CUDA each iteration runs the hand-written whole-iteration
kernel (ops/megakernel.py, csrc/full_iteration.cu); on the CPU, and only
when asked for, its plain PyTorch version.
"""

__version__ = "0.1.0"

from .models.scene import Scene, load_scene  # noqa: F401
from .render import Renderer, RenderSettings  # noqa: F401
