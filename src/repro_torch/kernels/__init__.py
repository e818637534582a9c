"""Hand-written CUDA kernels (``*/csrc/*.cu``), their build, and the
sliding-Goertzel monitor."""
