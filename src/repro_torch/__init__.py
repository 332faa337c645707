"""PyTorch + CUDA port of the ``repro`` collision engine for the NVIDIA H100.

The JAX package ``repro`` is the reference; this package keeps its module
paths so each counterpart is easy to find, and never imports it or JAX.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
