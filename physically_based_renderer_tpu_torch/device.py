"""Where the port's constructors put their tensors when the caller names no
device: the card. A caller that wants the CPU (the plain PyTorch versions of
the kernels, as the tests use them) passes ``device="cpu"``."""

DEFAULT_DEVICE = "cuda"
