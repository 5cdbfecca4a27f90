"""project3_cuda_path_tracer_tpu_torch: the path tracer ported to
PyTorch and CUDA (NVIDIA Hopper).

It mirrors the layout of the JAX package `project3_cuda_path_tracer_tpu`,
which stays the reference; this package imports neither that package
nor JAX. On CUDA an iteration runs hand-written kernels: the
whole-iteration kernel, or the per-bounce first-bounce / bounce / shade
kernels (ops/megakernel.py, csrc/), the NEE + MIS kernels, and on a mesh
scene the mesh pipeline (ops/pipeline.py: candidates, BVH sweep, the
big-mesh route's sorted supernode sweep, sorted by a counting sort or,
under PT_TPU_SORT_RADIX=1, by the radix kernels, merge + shade or
merge); on the CPU, and only when asked for, their plain PyTorch
versions, which also run on the card under --no-pallas
(`RenderSettings.plain`).
"""

__version__ = "0.1.0"

from .models.scene import Scene, load_scene  # noqa: F401
from .render import Renderer, RenderSettings  # noqa: F401
