"""Data of the port (``src/repro/data``): synthetic tokens, documents and
images, the byte-fallback tokenizer, the indexed dataset and the
sharded loader."""
from repro_torch.data.indexed import IndexedDatasetReader, IndexedDatasetWriter
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import (
    synthetic_images, synthetic_oscar_text, synthetic_tokens,
)
from repro_torch.data.tokenizer import ByteFallbackTokenizer

__all__ = [
    "IndexedDatasetReader", "IndexedDatasetWriter", "ShardedLoader",
    "synthetic_images", "synthetic_oscar_text", "synthetic_tokens",
    "ByteFallbackTokenizer",
]
