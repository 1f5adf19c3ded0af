"""TF32 matrix products, emulated: the precision of the correctness
check's control.

On the H100, a float32 matrix product with TF32 allowed rounds both
operands to TF32 (10 explicit mantissa bits, round to nearest with ties
away from zero) and accumulates in float32. `Tf32Products` does exactly
that to every matrix product called while it is active, on any device, so
the control reads the same on the card as in a CPU test, and whatever
cuBLAS would choose for a small matrix."""

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {
    torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
    torch.Tensor.__rmatmul__, torch.bmm, torch.Tensor.bmm, torch.mm,
    torch.Tensor.mm, torch.mv, torch.Tensor.mv, torch.einsum,
    torch.baddbmm, torch.addmm, torch.addbmm, torch.linalg.matmul,
    torch.tensordot, torch.inner, torch.outer,
}


def round_tf32(x):
    """x (float32) rounded to TF32's 10-bit mantissa; other tensors as
    they are."""
    if not (torch.is_tensor(x) and x.dtype == torch.float32):
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).reshape(x.shape)


class Tf32Products(TorchFunctionMode):
    """While active, every float32 matrix product rounds its operands to
    TF32 first."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple([round_tf32(a) for a in x] if isinstance(x, list)
                         else round_tf32(x) for x in args)
        return func(*args, **kwargs)
