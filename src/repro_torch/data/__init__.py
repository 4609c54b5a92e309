from repro_torch.data.synthetic import DATASETS, VecDB, make_dataset  # noqa: F401
