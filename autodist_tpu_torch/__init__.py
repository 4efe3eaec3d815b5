"""autodist_tpu_torch — the PyTorch / CUDA port of ``autodist_tpu``.

A second package beside the JAX one, with the same module paths. It imports
``torch`` and never JAX or the JAX package. Import-time behaviour mirrors
``autodist_tpu/__init__.py``: a backend version gate, then the public names.
"""
__version__ = "0.1.0"

import torch as _torch

# version gate, on the pattern of the JAX package's jax gate
_MIN_TORCH = (2, 1, 0)
_ver = tuple(int("".join(c for c in x if c.isdigit()) or 0)
             for x in _torch.__version__.split("+")[0].split(".")[:3])
if _ver < _MIN_TORCH:
    raise RuntimeError("autodist_tpu_torch requires torch >= %s, found %s"
                       % (".".join(map(str, _MIN_TORCH)), _torch.__version__))

from autodist_tpu_torch import const  # noqa: E402
from autodist_tpu_torch.autodist import (AutoDist, get_default_autodist,  # noqa: E402
                                         reset)
from autodist_tpu_torch.model_item import ModelItem  # noqa: E402
from autodist_tpu_torch.resource_spec import ResourceSpec  # noqa: E402
from autodist_tpu_torch.train_state import TrainState  # noqa: E402
from autodist_tpu_torch import strategy  # noqa: E402

ENV = const.ENV

__all__ = ["AutoDist", "ModelItem", "ResourceSpec", "TrainState", "strategy",
           "ENV", "get_default_autodist", "reset", "__version__"]
