"""The entry points' device rule, shared by ``autodist.py`` and
``models/lm.py``'s decode state."""
import torch


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: ``None`` means ``cuda``, and a CUDA
    device with no card visible raises — nothing falls back to the CPU
    unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "autodist_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be cuda or cpu, got %r" % (device,))
    return dev
