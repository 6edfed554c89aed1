"""asltpu_torch.ops — device-side preprocess (plain PyTorch and the CUDA
kernels of ``asltpu_torch/csrc``) and the GRU layer."""
