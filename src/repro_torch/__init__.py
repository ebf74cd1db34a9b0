"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module names (``cfd.spacetree``, ``cfd.multigrid``, ``cfd.projection``,
``cfd.scenarios``, ``cfd.sim``, ``kernels.stencil``, ``kernels.pack``) so a
reader finds each counterpart.  It imports nothing of ``repro`` and nothing
of JAX: the host-side TH5 I/O stack it needs is copied under ``core/`` and
``obs/``.  Entry points place tensors on ``device="cuda"`` unless the caller
passes another device.
"""
