"""PyTorch + CUDA port of the TN-KDE system (reference: the ``repro`` JAX
package beside it). Imports ``torch``, ``numpy`` and ``scipy`` only; CUDA
kernels are compiled at first use, never at import."""
