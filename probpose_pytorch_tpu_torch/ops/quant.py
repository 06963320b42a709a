"""int8 quantization primitives for serving (port of
probpose_pytorch_tpu/ops/quant.py).

Post-training dynamic quantization:
  * weights: symmetric per-output-channel int8 with float32 scales,
    converted once from the trained float32 parameters;
  * activations: symmetric per-row (per-token) int8, quantized on the fly;
  * products: int8 x int8 -> int32 by `torch._int_mm` (cuBLASLt's integer
    GEMM on the card), dequantized with row scale x column scale.

Rounding is half to even (`torch.round`, as `jnp.round`) and codes clip to
+-127, so the codes and scales equal JAX's bit for bit on the same float32
inputs, and the int32 products are exact. The float32 dequantization keeps
JAX's order: acc * x_scale * w_scale, then + bias, then the cast.

`torch._int_mm` on a CUDA tensor takes (M, K) x (K, N) with M > 16 and K
and N multiples of 8; JAX's `int8_matmul` (a plain `lax.dot_general`) takes
any shape. So `int8_matmul` pads what falls short with zeros, M to 17 and K
and N to multiples of 8 (`padded_int_mm`), and slices the product back:
integer sums with zero terms are exact, so the result is the unpadded
product bit for bit. Shapes that meet the rules pass through uncopied. A
(K, N) weight that is the transpose of a contiguous (N, K) tensor, as
models/vit_int8.py stores it, is the operand layout cuBLASLt's integer GEMM
takes without a copy; a padded copy is made in that layout.
"""

from __future__ import annotations

import torch

__all__ = [
    "quantize_weight",
    "int8_matmul",
    "dynamic_quantize_rows",
    "weight_only_matmul",
    "padded_int_mm",
    "int_mm_padding",
]

# torch._int_mm's rules on the card: more than 16 rows, K and N multiples of 8.
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 (1 where amax is 0), divided as XLA divides. PyTorch's CUDA
    division by a Python scalar multiplies by its rounded reciprocal, which
    is not the quotient; a divisor on the device divides exactly, on the
    card as on the CPU."""
    return torch.where(amax > 0, amax / amax.new_full((), 127.0), torch.ones_like(amax))


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 (in, out) kernel -> (int8 (in, out) kernel, float32 (out,)
    per-output-channel scale)."""
    w = w.float()
    scale = _scale(w.abs().amax(dim=0, keepdim=True))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale[0]


def dynamic_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K) float -> per-row int8 codes and (..., 1) float32 scales."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int_mm_padding(M: int, K: int, N: int) -> tuple[int, int, int]:
    """The (M, K, N) an int8 product of that shape is padded to before
    torch._int_mm: M at least 17, K and N rounded up to multiples of 8."""
    up = lambda n: -(-n // INT_MM_MULTIPLE) * INT_MM_MULTIPLE
    return max(M, INT_MM_MIN_ROWS), up(K), up(N)


def padded_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 (M, N) = a (M, K) int8 @ b (K, N) int8 by torch._int_mm, with
    zeros padded to `int_mm_padding`'s shape where (M, K, N) falls short of
    its rules and the product sliced back; equal bit for bit to the
    unpadded product. The padded b is the transpose of a contiguous
    (Np, Kp), the layout cuBLASLt's integer GEMM takes (it refuses two
    untransposed operands)."""
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = int_mm_padding(M, K, N)
    if (Mp, Kp, Np) == (M, K, N):
        return torch._int_mm(a, b)
    ap = a.new_zeros((Mp, Kp))
    ap[:M, :K] = a
    bp = b.new_zeros((Np, Kp)).t()
    bp[:K, :N] = b
    return torch._int_mm(ap, bp)[:M, :N]


def int8_matmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """y = x @ W (+ bias) with dynamic int8 activations and int8 weights.

    x: (..., K); w_q: (K, N) int8; w_scale: (N,) float32."""
    *lead, K = x.shape
    xq, x_scale = dynamic_quantize_rows(x.reshape(-1, K))
    acc = padded_int_mm(xq, w_q)
    y = acc.float() * x_scale * w_scale[None, :]
    if bias is not None:
        y = y + bias.float()[None, :]
    return y.reshape(*lead, w_q.shape[1]).to(out_dtype)


def weight_only_matmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = x @ dequant(W) (+ bias): int8 weights, activations as they come.
    The weights dequantize into x's dtype (w_q * scale, both in x's dtype)
    before one product in that dtype, as JAX's do."""
    w = w_q.to(x.dtype) * w_scale.to(x.dtype)[None, :]
    y = x @ w
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
