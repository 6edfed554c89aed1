"""asltpu_torch.data — host decode, batch padding, prefetch to the device."""
