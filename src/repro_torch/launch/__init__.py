"""Process-level launch helpers: the device mesh over `torch.distributed`
(`mesh`) and the multi-process smoke run (`multihost_smoke`)."""
