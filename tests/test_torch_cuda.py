"""The port's hand-written kernels against their plain versions on the card.

Every test here is `cuda`-marked and skips without an NVIDIA GPU; the skip
is decided inside the fixture. The file imports no jax, so that it runs on
a GPU machine without one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.ops.kernels import plain_versions
from probpose_pytorch_tpu_torch.ops.kernels.attention import (
    kernel_path,
    packed_attention,
    packed_attention_reference,
)
from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import (
    sparsemax_reference,
    sparsemax_rows,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,dtype,tol", [
    (64, torch.bfloat16, 4e-3),  # bf16 context: a few bf16 ulps at |ctx| < 1
    (3, torch.bfloat16, 4e-3),   # ragged batch, same bound
    (64, torch.float32, 1e-5),   # f32 sums in another order
])
def test_packed_attention_kernel(cuda_device, B, dtype, tol):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(B, 192, 1152, generator=g, device=cuda_device).to(dtype)
    before = packed_attention.launches
    out = packed_attention(qkv, 6)
    torch.cuda.synchronize()
    assert packed_attention.launches == before + 1
    err = (out.float() - packed_attention_reference(qkv, 6).float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("N,heads,d,path", [
    (200, 2, 64, "tensor cores"),  # keys padded to a multiple of 16
    (77, 4, 32, "tensor cores"),
    (50, 2, 128, "tensor cores"),
    (300, 2, 64, "CUDA cores"),    # N above the tensor-core path's 256
    (96, 3, 48, "CUDA cores"),     # d outside {32, 64, 128}
])
def test_packed_attention_kernel_paths_bf16(cuda_device, N, heads, d, path):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn(5, N, 3 * heads * d, generator=g, device=cuda_device)
    qkv = qkv.to(torch.bfloat16)
    assert kernel_path(N, d, torch.bfloat16) == path
    out = packed_attention(qkv, heads)
    torch.cuda.synchronize()
    err = (out.float() - packed_attention_reference(qkv, heads).float()).abs().max().item()
    assert err <= 4e-3, err  # a few bf16 ulps at |ctx| < 1


@pytest.mark.cuda
def test_packed_attention_kernel_refuses_unsupported(cuda_device):
    with pytest.raises(TypeError):
        packed_attention(torch.zeros(1, 8, 96, dtype=torch.float16, device=cuda_device), 2)
    with pytest.raises(ValueError, match="shared memory"):
        packed_attention(torch.zeros(1, 4096, 3 * 128, device=cuda_device), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [64 * 17, 17 * 3 + 5])
def test_sparsemax_kernel(cuda_device, R):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    z = torch.randn(R, 3072, generator=g, device=cuda_device) / 0.5
    before = sparsemax_rows.launches
    out = sparsemax_rows(z)
    torch.cuda.synchronize()
    assert sparsemax_rows.launches == before + 1
    assert (out - sparsemax_reference(z)).abs().max().item() <= 1e-6  # exact tau
    assert (out.sum(-1) - 1).abs().max().item() <= 1e-5  # on the simplex


@pytest.mark.cuda
def test_flagship_forward_kernels_vs_plain(cuda_device):
    """Full-width ViT-S forward in f32: kernel path against plain path, and
    12 K1 launches plus 1 K2 launch per forward."""
    cfg = ModelConfig(attn_impl="fused", compute_dtype="float32")
    model = build_model(cfg, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.rand(4, 256, 192, 3, generator=g, device=cuda_device)
    a0, s0 = packed_attention.launches, sparsemax_rows.launches
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
        assert packed_attention.launches - a0 == 12
        assert sparsemax_rows.launches - s0 == 1
        with plain_versions():
            ref = model(x)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        # f32 everywhere; attention sums in another order.
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-5)
