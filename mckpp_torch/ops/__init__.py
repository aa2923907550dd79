"""Physics ops: the plain torch bodies and the CUDA kernels that replace them on the card."""
