from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLMData,
    make_batch,
    make_embedding_batch,
)
