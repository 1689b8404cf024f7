"""repro_torch: the PyTorch/CUDA port of ``repro``, built slice by slice.

Public surface (the slices ported so far):
  repro_torch.core     — the collective algorithms, topology, cost model,
                         autotuner and the transport they run over
  repro_torch.kernels  — hand-written CUDA kernels for Hopper (+ their plain
                         PyTorch versions)
  repro_torch.configs  — the architecture registry and shape suites
  repro_torch.models   — the dense decoders: forward, loss, decode
  repro_torch.data     — the synthetic stream (JAX's threefry, bit for bit)
  repro_torch.optim    — AdamW, SGD-momentum and their schedules
  repro_torch.launch   — the step builders and the serve and train drivers
  repro_torch.interop  — turns the reference's host-side state (topology
                         constants, cost-model fields, parameters) into the
                         port's

The package imports torch and numpy, never jax and nothing of ``repro``.
Entry points run on CUDA unless the caller asks for ``device="cpu"``.
"""

__version__ = "1.0.0"
