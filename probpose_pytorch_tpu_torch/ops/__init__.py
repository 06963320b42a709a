"""Tensor ops of the port: preprocessing, sparsemax, heatmap decode, and the
hand-written kernels under `kernels/`."""
