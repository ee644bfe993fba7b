"""Quantization substrate: formats, scales, packing."""
from repro_torch.quant.qtypes import QuantizedTensor, pack_int4, unpack_int4  # noqa: F401
from repro_torch.quant.scales import compute_scale  # noqa: F401
