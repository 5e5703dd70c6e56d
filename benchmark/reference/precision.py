"""Operand precisions of the reference: f32 as the configurations state
it (TF32 off), and the control's TF32, the next precision below."""
import torch


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest even), as a
    tensor core reads an f32 operand; the gradient passes straight
    through, so a backward pass sees the rounded forward values."""
    i = x.detach().contiguous().view(torch.int32)
    odd = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    r = torch.bitwise_and(i + 0x0FFF + odd, ~0x1FFF)
    return x + (r.view(torch.float32).view_as(x) - x).detach()

