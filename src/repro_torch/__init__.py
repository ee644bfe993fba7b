"""PyTorch / CUDA port of the SQuant system (quantize on the fly, serve
real-quantized). Sub-packages mirror ``repro`` one-to-one so a module can be
diffed against its JAX counterpart. Imports ``torch`` only; importing any
module here needs neither a GPU nor a CUDA compiler — kernels are built the
first time one is launched."""
