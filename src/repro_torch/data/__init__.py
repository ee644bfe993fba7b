"""Data: the byte tokenizer and the synthetic token streams."""
from repro_torch.data.synthetic import (markov_batches,  # noqa: F401
                                        synthetic_batches)
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: F401
