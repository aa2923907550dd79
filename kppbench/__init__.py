"""The benchmark of the PyTorch and CUDA port (mckpp_torch): see README.md."""
