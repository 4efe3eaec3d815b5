"""The entry points' device rule, shared by ``autodist.py`` and
``models/lm.py``'s decode state."""
import torch


def resolve_device(device=None, local_rank=None) -> torch.device:
    """The entry points' device rule: ``None`` means ``cuda`` — for a rank
    of a multi-process group, ``cuda:<local_rank>`` — and a CUDA device
    that is not visible raises: nothing falls back to the CPU, or to
    another card, unless the caller asked for it."""
    if device is None:
        device = "cuda" if local_rank is None else "cuda:%d" % local_rank
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "autodist_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is not None and \
            dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            "device %s does not exist: %d CUDA device(s) are visible; pass "
            "the device of this rank explicitly" % (dev,
                                                    torch.cuda.device_count()))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be cuda or cpu, got %r" % (device,))
    return dev
