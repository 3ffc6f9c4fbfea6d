"""Kernels of the PyTorch port: ``hopper`` holds one module per Pallas
file of ``paddle_tpu/ops/pallas`` that has been ported."""
