"""Plain PyTorch version of the ball-query kernel: the core brute force.

Contract (``repro.kernels.ballquery.ops.ball_query_tiled``, and the CUDA
``csrc/ballquery.cu``): the first ``k`` point indices, ascending, within
``radius`` of each query, -1 padded, and ``count = min(hits, k)``.  Note
the argument order, ``(points, queries, ...)``, the reference's.
"""
from repro_torch.core.ballquery import ball_query_ref  # noqa: F401
