"""Data: the byte tokenizer (the synthetic streams are not ported yet)."""
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: F401
