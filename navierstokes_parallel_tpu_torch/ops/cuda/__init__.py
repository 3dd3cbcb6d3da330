"""Hand-written CUDA kernels (sources in ../../csrc/) with their plain
PyTorch twins; the counterpart of the JAX package's ops/pallas/."""
