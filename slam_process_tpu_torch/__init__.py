"""PyTorch / CUDA port of the slam_process_tpu session pipeline.

The package runs the single-session pipeline (hex log -> bytes -> decoded
frames -> CLK-corrected beams -> 64x64 intensity grid -> blurred,
normalised, colour-mapped raster) on an NVIDIA H100.  Three stages run as
hand-written ``sm_90a`` CUDA kernels (``csrc/``): decode, the corrector's
per-row verdicts and the raster.  Each kernel has a plain PyTorch version
beside it that runs on CPU tensors and is what the kernel is checked
against.

Entry points take ``device=None``, which means ``"cuda"``; pass
``device="cpu"`` to run the plain versions on the host.  The package
imports ``torch`` and ``numpy`` only.
"""

__version__ = "0.1.0"
