"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref``) and a wrapper (``ops``) that launches the kernel for CUDA
tensors and runs the plain version for CPU tensors."""
