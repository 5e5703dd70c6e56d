"""Operations and bytes of the program's kernels and of a whole step,
from shapes and unique-row counts, and the card's peaks (`peaks`). One
module a kernel or step, found by name (`load`). Each input byte counts
once and each output byte once, however often a kernel reads it."""
import importlib

from .peaks import bound_s


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")


__all__ = ["bound_s", "load"]
