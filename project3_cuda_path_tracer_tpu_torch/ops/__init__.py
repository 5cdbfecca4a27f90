"""PyTorch ops of the port: the plain versions and the kernel wrappers."""
