"""PyTorch/CUDA port of the slab-class learning system.

The JAX package ``repro`` is the reference; this package computes the same
results with PyTorch and hand-written CUDA kernels for the H100, module for
module (``core``, ``memcached``, ``kernels``, ``analysis``). It imports
neither ``jax`` nor ``repro``. Entry points take ``torch_device`` (default
``"cuda"``) and raise when CUDA is missing; tests pass ``"cpu"``, where the
kernels' plain PyTorch versions run. ``convert`` carries state over from
reference objects exported to numpy.
"""
