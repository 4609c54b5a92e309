"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, their
plain PyTorch versions (``ref.py``) and the dispatcher (``ops.py``)."""
