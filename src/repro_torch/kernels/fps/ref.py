"""Plain PyTorch version of the FPS kernel: the core implementation.

Contract (``repro.kernels.fps.ops.fps_pallas``, and the CUDA
``csrc/fps.cu``): ``m`` int32 indices per cloud, index 0 is ``first``,
each next one the point whose squared distance to the chosen set is
largest, the first index on ties.
"""
from repro_torch.core.fps import farthest_point_sampling as fps_ref  # noqa: F401
