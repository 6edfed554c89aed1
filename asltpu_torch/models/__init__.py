"""asltpu_torch.models — MobileNetV2 + GRU head for ``mobilenet_gru``."""
