"""APM008 known-good fixture (the port's form): the card reached through
the CUDA seam (device/cuda.py) and the kernel wrappers; queries of the
card are not confined."""
import torch

from adapm_tpu_torch.device import cuda as dcuda
from adapm_tpu_torch.ops import kernels


def wait(dev):
    dcuda.synchronize(dev)
    return dcuda.stream_idle(dev)


def describe():
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0), torch.cuda.device_count()


def launch(pool, sh, sl, vals):
    kernels.build()
    return kernels.drop_set(pool, sh, sl, vals)
