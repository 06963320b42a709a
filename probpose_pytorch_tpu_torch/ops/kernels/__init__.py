"""Hand-written Hopper kernels of the port, each beside its plain version.

    attention.py   K1 forward and backward, and K6 (the same forward read from
                   (B, N, heads, d) views): the shape picks the kernel
                   (`attention_route`); f32 on the CUDA cores in CUDA C++
                   (csrc/packed_attention.cu)
    attention_tiled.py
                   K4 row-tiled attention for long sequences, forward and
                   backward, and K1's short bf16 forward: CUDA C++ with wgmma
                   and TMA in bf16 (csrc/tiled_attention_sm90.cu), on the
                   CUDA cores in f32 (csrc/tiled_attention.cu)
    sparsemax.py   K2 row sparsemax, CUDA C++ (csrc/sparsemax.cu): one warp a
                   row up to 3,072 pixels, one block a row beyond, the
                   bisection over the row's candidates only
    decode.py      K3 fused expected-value decode, CUDA C++ (csrc/decode.cu):
                   products over the OKS operators' band, strips of a map
                   staged once
    mlp.py         K5 fused LayerNorm + MLP + residual, forward and backward:
                   CUDA C++ with wgmma and TMA in bf16 (csrc/fused_mlp_sm90.cu),
                   on the CUDA cores in f32 (csrc/fused_mlp.cu)

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel (or raises) for a CUDA tensor; it never falls back.

The forward launches a serving program makes are `torch.library` custom ops
in the `probpose::` namespace (`SERVING_OPS`), so that `torch.export`
records each as one graph node and a loaded program launches the same
kernel: K1's short wgmma forward (`short_attention_fwd`) and its CUDA-core
forward (`packed_attention_fwd`), K4's forward (`tiled_attention_fwd`), K6
(`flat_attention_fwd`), K5's forward (`fused_ln_mlp_fwd`) and K2
(`sparsemax_rows`). An op's body is the launch and its `.launches` count;
its fake implementation gives the output shapes and touches neither the
library nor nvcc. `register_ops()` imports the modules that define them,
which import only torch, ctypes and this package; a program that holds
them loads after it.
`plain_versions()` is the one exception, an explicit switch with which
chip_smoke.py and the tests run the same model through the plain versions
on the card to compare the two paths.
"""

from __future__ import annotations

import contextlib

__all__ = ["plain_versions", "plain_enabled", "use_plain", "register_ops", "SERVING_OPS"]

# The `probpose::` ops, by the module that defines them.
SERVING_OPS = {
    "attention_tiled": ("short_attention_fwd", "tiled_attention_fwd"),
    "attention": ("packed_attention_fwd", "flat_attention_fwd"),
    "mlp": ("fused_ln_mlp_fwd",),
    "sparsemax": ("sparsemax_rows",),
}

_PLAIN = False


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain version, CUDA tensors too."""
    global _PLAIN
    prev, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = prev


def plain_enabled() -> bool:
    return _PLAIN


def use_plain(t, what: str) -> bool:
    """True for the plain version (CPU tensor, or `plain_versions()` on);
    False for the kernel (CUDA tensor); raises for any other device."""
    if t.device.type == "cpu" or (t.is_cuda and _PLAIN):
        return True
    if not t.is_cuda:
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


def register_ops() -> tuple[str, ...]:
    """Register every `probpose::` op (importing the modules that define
    them builds nothing); returns their qualified names."""
    import importlib

    for module in SERVING_OPS:
        importlib.import_module(f"{__name__}.{module}")
    return tuple(f"probpose::{op}" for ops in SERVING_OPS.values() for op in ops)
