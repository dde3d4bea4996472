"""PyTorch/CUDA port of the ``repro`` package (DOMINO constrained serving).

Subpackages mirror ``repro``'s: ``configs``, ``core`` and ``tokenizer`` are
copies of the framework-free originals; ``kernels``, ``models``,
``serving`` and ``launch`` are ported to PyTorch, with hand-written CUDA
kernels for Hopper.  Nothing here imports ``jax`` or ``repro``.
"""
