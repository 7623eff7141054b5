from repro_torch.data.pipeline import SyntheticLMData, make_batch  # noqa: F401
