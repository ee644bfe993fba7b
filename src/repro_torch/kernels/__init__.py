"""Hand-written CUDA kernels (``csrc/*.cu``), their wrappers and their plain
PyTorch versions. Nothing is compiled at import; see ``_build.py``."""
