"""Hand-written Hopper kernels of the port (``csrc/``), each beside its
plain PyTorch version (``ref.py``) and its dispatching wrapper (``ops.py``).
"""
