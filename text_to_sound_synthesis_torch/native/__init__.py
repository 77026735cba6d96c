"""The port's host-side native components, loaded via ctypes: the batched
.npy mel loader of the input pipeline (a copy of the JAX package's). It
builds lazily with plain ``g++``; where that fails the datasets read with
numpy, so nothing here is load-bearing for correctness, only for the input
pipeline's throughput.
"""

from .npy_loader import load_mel_batch, native_available, npy_shape

__all__ = ["load_mel_batch", "native_available", "npy_shape"]
