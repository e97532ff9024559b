"""PyTorch/CUDA port of the DSVT detector, for one NVIDIA H100.

Points -> boxes in PyTorch, with the four kernels that the JAX package wrote
in Pallas for the TPU (segmented max, set attention, encoder epilogue,
rotated-box overlap), and NMS's peeling loop, written by hand in CUDA C++
(``csrc/``) for sm_90a.  Every kernel has a plain PyTorch version beside
it: a tensor on the CPU takes the plain version, a tensor on the card takes
the kernel.  On the card the served forward is one CUDA graph a frame
(runtime/compile.py:Engine).  The package
imports neither JAX nor ``dsvt_ai_trt_tpu``; it keeps its own copies of the
configuration, weights and I/O code.
"""

from .config import DSVTConfig, DEFAULT_CONFIG, WAYMO_CONFIG, WindowSpec

__version__ = "0.1.0"
__all__ = ["DSVTConfig", "DEFAULT_CONFIG", "WAYMO_CONFIG", "WindowSpec"]
