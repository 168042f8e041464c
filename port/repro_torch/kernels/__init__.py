"""Hand-written CUDA kernels of the lookup descent (``ops``), their plain
PyTorch versions (``ref``) and the nvcc build (``build``)."""
