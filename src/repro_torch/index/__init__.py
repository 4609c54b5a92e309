"""The port's Index API — build, persist and search an index on one device.

    from repro_torch.index import Index, IndexSpec, SearchParams

    idx = Index.build(db, IndexSpec.for_db(db, m=16))        # device="cuda"
    idx.save("idx.naszip");  idx = Index.load("idx.naszip")
    run = idx.searcher("local", SearchParams(ef=64, k=10))
    result = run(queries)            # SearchResult(ids, dists, ...)
"""
from repro_torch.core.fee import FeeParams  # noqa: F401
from repro_torch.index.backends import BACKENDS  # noqa: F401
from repro_torch.index.convert import from_arrays  # noqa: F401
from repro_torch.index.device import DeviceCache, UploadStats  # noqa: F401
from repro_torch.index.index import Index  # noqa: F401
from repro_torch.index.types import (  # noqa: F401
    FeeFit, IndexSpec, SearchParams, SearchResult)
from repro_torch.resilience import CorruptArtifactError  # noqa: F401
