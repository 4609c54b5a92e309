"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, their
plain PyTorch versions (``ref.py``) and the dispatcher (``ops.py``)."""
# The kernels read ``core.dfloat``, and ``core`` imports ``core.search``,
# which dispatches through ``ops``: loading ``core`` first lets any module
# of this package be the first one a program imports.
import repro_torch.core  # noqa: F401
