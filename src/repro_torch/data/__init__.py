"""Token data: the numpy pipeline of the JAX package, copied."""

from repro_torch.data.pipeline import (  # noqa: F401
    MemmapCorpus,
    Prefetcher,
    SyntheticTokens,
    write_corpus,
)
