"""repro_torch: the PyTorch/CUDA port of ``repro``, built slice by slice.

Public surface (this slice):
  repro_torch.core     — the collective algorithms, topology, cost model,
                         autotuner and the transport they run over
  repro_torch.kernels  — hand-written CUDA kernels for Hopper (+ their plain
                         PyTorch versions)
  repro_torch.interop  — turns the reference's host-side state (topology
                         constants, cost-model fields) into the port's

The package imports torch and numpy, never jax and nothing of ``repro``.
Entry points run on CUDA unless the caller asks for ``device="cpu"``.
"""

__version__ = "1.0.0"
