"""NasZip core: FEE-sPCA + Dfloat, graph index, beam search, DaM, and the
PQ / RaBitQ baselines the paper compares against."""
from repro_torch.core import baselines, dfloat, fee, graph, pca, search  # noqa: F401
