"""The precision of the reference's products.

'float32' computes every product in float32 with TF32 off. A lower
precision computes the field's products in it, accumulating in float32 as
tensor cores do:

* 'tf32': both operands rounded to 10 mantissa bits (on the card TF32 is
  also switched on, so the backward products run in it too);
* 'fp8', the hybrid recipe of fp8 training: operands and results in e4m3
  (a field computed in a type holds its activations in it),
  the gradients that enter the backward products in e5m2, each tensor with
  a scale to its format's largest value.

The rounding passes gradients straight through, and an 8-bit product's
backward is itself differentiable (the SDF's input gradient is trained).
The control of a float32 configuration is 'tf32'; a bfloat16 one's
'fp8'."""

from __future__ import annotations

import contextlib

import torch

FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def _round_fp8(t: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    dtype, top = FP8[fmt]
    scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


_ROUND = {"tf32": _round_tf32, "fp8": _round_fp8}
# an 8-bit product's rounding of its operands and of the gradient it takes back
_EIGHT_BIT = {"fp8": (_round_fp8, lambda t: _round_fp8(t, "e5m2"))}


def straight(t: torch.Tensor, fn) -> torch.Tensor:
    """fn(t) in value, t's gradient."""
    return t + (fn(t.detach()) - t).detach()


class _EightBitProduct(torch.autograd.Function):
    """x @ w.T with 8-bit operands; its backward takes the incoming gradient
    in 8 bits too, in differentiable operations."""

    @staticmethod
    def forward(ctx, x, w, name):
        ctx.save_for_backward(x, w)
        ctx.name = name
        fwd = _EIGHT_BIT[name][0]
        return fwd(x) @ fwd(w).t()

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        fwd, bwd = _EIGHT_BIT[ctx.name]
        g = straight(gy, bwd)
        return g @ straight(w, fwd), g.t() @ straight(x, fwd), None


class Precision:
    def __init__(self, name: str = "float32"):
        if name != "float32" and name not in _ROUND:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "float32" else straight(t, _ROUND[self.name])

    def linear(self, x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
        if self.name in _EIGHT_BIT:
            y = _EightBitProduct.apply(x, w, self.name)
        else:
            y = self.operand(x) @ self.operand(w).t()
        if b is not None:
            y = y + b
        return self.operand(y) if self.name in _EIGHT_BIT else y

    @contextlib.contextmanager
    def context(self):
        """TF32 as this precision wants it, for the duration."""
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
