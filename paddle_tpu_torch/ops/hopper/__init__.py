"""Hand-written Hopper (sm_90a) kernels, one module per ported Pallas
file, same basenames and entry points. Each module holds the kernel's
wrapper (CUDA tensors launch the kernel from ``paddle_tpu_torch/csrc``),
its plain PyTorch version (the only path for CPU tensors) and a launch
counter."""
