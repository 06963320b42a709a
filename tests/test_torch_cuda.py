"""The port's hand-written kernels against their plain versions on the card.

Every test here is `cuda`-marked and skips without an NVIDIA GPU; the skip
is decided inside the fixture. The file imports no jax, so that it runs on
a GPU machine without one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.ops.heatmap import (
    build_oks_conv_operators,
    expected_value_decode,
    oks_conv,
)
from probpose_pytorch_tpu_torch.ops.kernels import plain_versions
from probpose_pytorch_tpu_torch.ops.kernels.attention import (
    fused_attention,
    fused_attention_reference,
    kernel_path,
    packed_attention,
    packed_attention_backward,
    packed_attention_bwd_reference,
    packed_attention_reference,
)
from probpose_pytorch_tpu_torch.ops.kernels.mlp import (
    SUPPORTED_WIDTHS,
    fused_ln_mlp,
    fused_ln_mlp_backward,
    fused_ln_mlp_bwd_kernel_order_reference,
    fused_ln_mlp_bwd_reference,
    fused_ln_mlp_reference,
    mlp_workspace_bytes,
)
from probpose_pytorch_tpu_torch.ops.kernels.attention_tiled import (
    k1_smem_bytes,
    short_attention_reference,
    short_forward,
    tiled_attention,
    tiled_attention_backward,
    tiled_attention_bwd_reference,
    tiled_attention_online_bwd_reference,
    tiled_attention_online_reference,
    tiled_attention_reference,
    tiled_forward,
)
from probpose_pytorch_tpu_torch.ops.kernels.decode import (
    expected_value_decode_banded_reference,
    expected_value_decode_fused,
)
from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import (
    BLOCK_CANDIDATES,
    WARP_CANDIDATES,
    block_smem_bytes,
    sparsemax_candidates_reference,
    sparsemax_reference,
    sparsemax_rows,
)

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

# The 17 COCO keypoint sigmas (probpose_pytorch_tpu/data/coco.py, which this
# file may not import): their OKS operators have band radii 2 to 9.
COCO_SIGMAS = [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
               0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bound(ref: torch.Tensor) -> float:
    """Error bound relative to the output's magnitude. bf16: two bf16 ulps
    (2 * 2**-8) of max(1, max|ref|) -- where an f32 sum taken in another
    order lands on the other side of a rounding boundary, the output moves
    by one ulp of its own size, which an absolute bound would miss for
    outputs >= 1. f32: 1e-5 of the same scale, for sums in another order."""
    rel = 2 * 2**-8 if ref.dtype == torch.bfloat16 else 1e-5
    return rel * max(1.0, ref.float().abs().max().item())


def max_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (out.float() - ref.float()).abs().max().item()


def forward_launches() -> int:
    """Launches of every kernel packed_attention's forward may route to."""
    return packed_attention.launches + short_forward.launches + tiled_attention.launches


def backward_launches() -> int:
    return packed_attention_backward.launches + tiled_attention_backward.launches


@pytest.mark.cuda
@pytest.mark.parametrize("B,dtype", [
    (64, torch.bfloat16),
    (3, torch.bfloat16),   # ragged batch
    (64, torch.float32),
])
def test_packed_attention_kernel(cuda_device, B, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(B, 192, 1152, generator=g, device=cuda_device).to(dtype)
    before = forward_launches()
    out = packed_attention(qkv, 6)
    torch.cuda.synchronize()
    assert forward_launches() == before + 1
    ref = packed_attention_reference(qkv, 6)
    assert max_err(out, ref) <= bound(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,dtype", [
    (64, torch.bfloat16),
    (3, torch.bfloat16),   # ragged batch
    (64, torch.float32),
])
def test_packed_attention_backward_kernel(cuda_device, B, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    qkv = torch.randn(B, 192, 1152, generator=g, device=cuda_device).to(dtype)
    dout = torch.randn(B, 192, 384, generator=g, device=cuda_device).to(dtype)
    before = backward_launches()
    dqkv = packed_attention_backward(qkv, dout, 6)
    torch.cuda.synchronize()
    assert backward_launches() == before + 1
    ref = packed_attention_bwd_reference(qkv, dout, 6)
    assert max_err(dqkv, ref) <= bound(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_attention_autograd_on_card(cuda_device, dtype):
    """torch.autograd.grad through the kernel equals the gradient through
    the plain forward differentiated by autograd (f32) or the plain
    backward with the kernel's roundings (bf16)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn(8, 192, 1152, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(8, 192, 384, generator=g, device=cuda_device).to(dtype)
    x = qkv.clone().requires_grad_(True)
    before = backward_launches()
    (grad,) = torch.autograd.grad((packed_attention(x, 6).float() * w.float()).sum(), x)
    torch.cuda.synchronize()
    assert backward_launches() == before + 1
    assert grad.grad_fn is None and grad.dtype == dtype
    if dtype == torch.float32:
        y = qkv.clone().requires_grad_(True)
        (ref,) = torch.autograd.grad((packed_attention_reference(y, 6) * w).sum(), y)
    else:
        ref = packed_attention_bwd_reference(qkv, w, 6)
    assert max_err(grad, ref) <= bound(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("N,heads,d,path", [
    (200, 2, 64, "sm90 short"),     # keys padded to a multiple of 64
    (77, 4, 32, "sm90 short"),
    (50, 2, 128, "sm90 short"),
    (300, 2, 64, "sm90 tiled"),     # N above the short forward's 256
    (96, 3, 48, "K1 CUDA cores"),   # d outside {32, 64, 128}
])
def test_packed_attention_kernel_paths_bf16(cuda_device, N, heads, d, path):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn(5, N, 3 * heads * d, generator=g, device=cuda_device)
    qkv = qkv.to(torch.bfloat16)
    assert kernel_path(N, d, torch.bfloat16) == path
    out = packed_attention(qkv, heads)
    torch.cuda.synchronize()
    ref = packed_attention_reference(qkv, heads)
    assert max_err(out, ref) <= bound(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("N,heads,d,dtype,path", [
    (200, 2, 64, torch.bfloat16, "sm90 tiled"),  # queries/keys past a 64-row tile
    (77, 4, 32, torch.bfloat16, "sm90 tiled"),
    (300, 2, 64, torch.bfloat16, "sm90 tiled"),  # N above 256
    (96, 3, 48, torch.bfloat16, "K1 CUDA cores"),  # d outside {32, 64, 128}
    (192, 2, 128, torch.bfloat16, "sm90 tiled"),  # ran on CUDA cores before
    (77, 3, 40, torch.float32, "K1 CUDA cores"),
])
def test_packed_attention_backward_kernel_paths(cuda_device, N, heads, d, dtype, path):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    qkv = torch.randn(5, N, 3 * heads * d, generator=g, device=cuda_device).to(dtype)
    dout = torch.randn(5, N, heads * d, generator=g, device=cuda_device).to(dtype)
    assert kernel_path(N, d, dtype, backward=True) == path
    dqkv = packed_attention_backward(qkv, dout, heads)
    torch.cuda.synchronize()
    ref = packed_attention_bwd_reference(qkv, dout, heads)
    assert max_err(dqkv, ref) <= bound(ref)


@pytest.mark.cuda
def test_packed_attention_kernel_refuses_unsupported(cuda_device):
    with pytest.raises(TypeError):
        packed_attention(torch.zeros(1, 8, 96, dtype=torch.float16, device=cuda_device), 2)
    # K4 takes no head width of 48, so past K1's shared memory
    # packed_attention has no kernel for it and says so
    with pytest.raises(ValueError, match="head width"):
        tiled_attention(torch.zeros(1, 4096, 3 * 96, device=cuda_device), 2)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.zeros(1, 1024, 3 * 96, device=cuda_device, dtype=dtype)
        with pytest.raises(NotImplementedError, match="no kernel"):
            packed_attention(qkv, 2)
        with pytest.raises(NotImplementedError, match="no kernel"):
            packed_attention_backward(qkv, qkv[..., :96].contiguous(), 2)
    # the short forward takes no N above 256
    with pytest.raises(ValueError, match="N <= 256"):
        short_forward(torch.zeros(1, 300, 3 * 128, device=cuda_device, dtype=torch.bfloat16), 2)


def simplex_bound(out: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Per row, how far a float32 sparsemax row may sum from 1: 1e-5, or one
    ulp of tau (2**-23 max(1, |max z|)) for each support element where that
    is more, since every output z - tau carries tau's rounding (the plain
    version's rows of 65,536 pixels all within 1 of the max, ~350 in the
    support, sum 1.04e-5 from 1)."""
    ulps = (out > 0).sum(-1) * 2.0**-23 * z.abs().amax(-1).clamp_min(1.0)
    return ulps.clamp_min(1e-5)


def check_sparsemax(z: torch.Tensor, capacity: int = BLOCK_CANDIDATES) -> None:
    """K2 once: one launch, within 1e-6 of the plain version and of its plain
    twin (exact tau from the same support, f32 sums in another order), rows
    on the simplex, and a second launch bit-identical."""
    before = sparsemax_rows.launches
    out = sparsemax_rows(z)
    again = sparsemax_rows(z)
    torch.cuda.synchronize()
    assert sparsemax_rows.launches == before + 2
    assert (out - sparsemax_reference(z)).abs().max().item() <= 1e-6
    assert (out - sparsemax_candidates_reference(z, capacity)).abs().max().item() <= 1e-6
    assert ((out.sum(-1) - 1).abs() <= simplex_bound(out, z)).all()  # on the simplex
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(64 * 17, 3072), (17 * 3 + 5, 3072), (5, 1), (3, 5),
                                 (7, 300), (5, 3071), (5, 3073), (3, 65536),
                                 (32 * 20, 9216)])
def test_sparsemax_kernel(cuda_device, R, N):
    """Random rows, ragged R and N: the short-row kernel (N <= 3,072, with
    and without float4 loads), the staged long-row kernel (3,073; 9,216,
    the fieldsynth recipe's 96 x 96 heatmaps of a batch of 32) and the
    one that reads device memory on each pass (65,536)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    check_sparsemax(torch.randn(R, N, generator=g, device=cuda_device) / 0.5,
                    WARP_CANDIDATES if N <= 3072 else BLOCK_CANDIDATES)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [300, 3072, 36864, 65536])
@pytest.mark.parametrize("rows", ["all candidates", "ties", "at lo0"])
def test_sparsemax_kernel_adversarial_rows(cuda_device, N, rows):
    """Rows whose every element is a candidate (within 1 of the max: the
    buffer overflows past 1,024 or 4,096 and the bisection runs over the
    whole row), rows that tie at the max, and rows with elements exactly at
    lo0 = max - 1, which are no candidates."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    z = torch.rand(6, N, generator=g, device=cuda_device)
    if rows == "ties":
        z = torch.randn(6, N, generator=g, device=cuda_device) / 0.5
        z[:, :: max(1, N // 7)] = z.amax(dim=-1, keepdim=True)
    elif rows == "at lo0":
        z = 4.0 * z
        z[:, 0], z[:, 1:: max(1, N // 9)] = 5.0, 4.0
    check_sparsemax(z, WARP_CANDIDATES if N <= 3072 else BLOCK_CANDIDATES)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [3073, 36864, 65536])
def test_sparsemax_block_smem_bytes_match_the_library(cuda_device, N):
    from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import _lib

    for staged in (False, True):
        assert _lib().sparsemax_block_smem_bytes(N, int(staged)) + 256 == \
            block_smem_bytes(N, staged)


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


@pytest.mark.cuda
def test_simcc_forward_kernels_vs_plain(cuda_device):
    """The SimCC head on the full-width ViT-S trunk in f32
    (configs/simcc_coco_vits.json's model): 12 attention forwards and no
    K2 launch per forward; logits and scalars through the kernels against
    the plain path (attention sums in another order)."""
    cfg = ModelConfig(attn_impl="fused", compute_dtype="float32", head_type="simcc",
                      pool_sizes=((4, 3), (2, 2), (2, 2)))
    model = build_model(cfg, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.rand(4, 256, 192, 3, generator=g, device=cuda_device)
    f0, s0 = forward_launches(), sparsemax_rows.launches
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
        assert (forward_launches() - f0, sparsemax_rows.launches - s0) == (12, 0)
        with plain_versions():
            ref = model(x)
    assert out[0][0].shape == (4, 17, 384) and out[0][1].shape == (4, 17, 512)
    for o, r in zip((*out[0], *out[1:]), (*ref[0], *ref[1:])):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-5)


def _peak_heatmap_branch(model, seed=1):
    """Heatmap-branch convs at fan-in scale: peaked maps, a well-defined
    argmax for the loss's in-step decode."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in [*model.head.deconvs, model.head.final]:
            fan_in = m.weight[0].numel() if isinstance(m, torch.nn.Conv2d) else m.weight.shape[0] * 4
            m.weight.copy_(torch.randn(m.weight.shape, generator=g).to(m.weight.device)
                           / fan_in**0.5)


@pytest.mark.cuda
def test_train_step_kernels_vs_plain(cuda_device):
    """One float32 train step of a small ViT through the kernels against the
    same step through the plain versions: 2 K1 forward, 2 K1 backward and
    1 K2 launch (depth 2)."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.train.config import TrainConfig
    from probpose_pytorch_tpu_torch.train.loop import Trainer

    cfg = TrainConfig.from_dict(dict(
        model=dict(img_size=(64, 48), num_keypoints=5, backbone="vit-nano",
                   compute_dtype="float32", deconv_out_channels=(16, 16),
                   pool_sizes=((2, 2), (2, 2)), attn_impl="fused"),
        optim=dict(ema_decay=0.999, max_nonfinite_skips=5), epochs=10, resume=False))
    ds = SyntheticPoseDataset(8, (64, 48), 5)
    batch = next(iter(batch_iterator(ds, 8, num_workers=1)))
    trainers = [Trainer.create(cfg, 1, cuda_device) for _ in range(2)]
    for t in trainers:
        _peak_heatmap_branch(t.model)
    counts = (packed_attention.launches, packed_attention_backward.launches,
              sparsemax_rows.launches)
    _, mk = trainers[0].train_step(trainers[0].state, trainers[0].device_batch(batch))
    torch.cuda.synchronize()
    assert (packed_attention.launches - counts[0], packed_attention_backward.launches
            - counts[1], sparsemax_rows.launches - counts[2]) == (2, 2, 1)
    with plain_versions():
        _, mp = trainers[1].train_step(trainers[1].state, trainers[1].device_batch(batch))
    for key in mp:
        # loss terms 1e-5 relative; the pre-clip norm 1e-4 (sums in another order)
        rtol = 1e-4 if key == "grad_norm" else 1e-5
        torch.testing.assert_close(mk[key], mp[key], rtol=rtol, atol=1e-12, msg=key)
    lr = float(trainers[0].tx.schedule(torch.zeros((), dtype=torch.int32)))
    for a, b in zip(trainers[0].state.params, trainers[1].state.params):
        # Adam's first step moves every element by at most ~lr, so the two
        # paths differ by at most 2 lr wherever a tiny gradient flips sign.
        assert (a - b).abs().max().item() <= 2 * lr


@pytest.mark.cuda
def test_optimizer_skips_nonfinite_gradients_on_card(cuda_device):
    from probpose_pytorch_tpu_torch.train.config import OptimConfig
    from probpose_pytorch_tpu_torch.train.state import make_optimizer

    tx = make_optimizer(OptimConfig(max_nonfinite_skips=1), 10)
    params = [torch.randn(5, device=cuda_device), torch.randn(3, 4, device=cuda_device)]
    state = tx.init(params)
    for i, bad in enumerate((float("nan"), float("inf"))):
        grads = [torch.ones_like(p) for p in params]
        grads[1][1, 2] = bad
        updates, state = tx.update(grads, state, params)
        assert not bool(state.last_finite) and int(state.notfinite_count) == i + 1
        if i == 0:  # skipped: no update, inner counts unchanged
            assert all(bool((u == 0).all()) for u in updates)
            assert int(state.count) == 0 and int(state.schedule_count) == 0
        else:  # more than max_nonfinite_skips in a row: applied
            assert int(state.count) == 1 and not bool(torch.isfinite(updates[1]).all())


def mlp_args(g, R, C, dtype, device, hidden=None):
    """(x, scale, bias, w1, b1, w2, b2) of kernel K5: x and the weights in
    `dtype` (the weights at fan-in scale), the LayerNorm and bias vectors
    float32, w1 and w2 as the transposed views a Linear's weight gives; the
    hidden width 4 C unless given."""
    f32 = dict(generator=g, device=device)
    Hd = hidden or 4 * C
    x = torch.randn(R, C, **f32).to(dtype)
    scale = 1 + 0.1 * torch.randn(C, **f32)
    bias = 0.1 * torch.randn(C, **f32)
    w1 = (torch.randn(Hd, C, **f32) / C**0.5).to(dtype).t()
    w2 = (torch.randn(C, Hd, **f32) / Hd**0.5).to(dtype).t()
    return x, scale, bias, w1, 0.1 * torch.randn(Hd, **f32), w2, 0.1 * torch.randn(C, **f32)


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,dtype,exact", [
    (12 * 192, 768, torch.bfloat16, False),  # ViT-B rows of 12 crops
    (3 * 192 + 7, 768, torch.bfloat16, False),  # ragged last tile
    (3 * 192 + 7, 768, torch.bfloat16, True),  # erf GELU
    (8 * 192 + 5, 384, torch.bfloat16, False),
    (4 * 192 + 3, 1024, torch.bfloat16, False),
    (2 * 192 + 9, 1280, torch.bfloat16, True),
    (2 * 192 + 7, 768, torch.float32, False),  # CUDA cores
    (97, 384, torch.float32, True),
])
def test_fused_ln_mlp_kernel(cuda_device, R, C, dtype, exact):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    args = mlp_args(g, R, C, dtype, cuda_device)
    before = fused_ln_mlp.launches
    out = fused_ln_mlp(*args, exact)
    torch.cuda.synchronize()
    assert fused_ln_mlp.launches == before + 1 and out.dtype == dtype
    ref = fused_ln_mlp_reference(*args, exact)
    assert max_err(out, ref) <= bound(ref)


def grad_bound(ref: torch.Tensor, dtype: torch.dtype) -> float:
    """K5 backward's bound, relative to each cotangent's magnitude. bf16:
    four bf16 ulps (4 * 2**-8) of max|ref| -- the kernel's tensor-core
    products take du rounded to bf16 where the plain version keeps it f32,
    and dy, dW1 and dW2 are rounded to bf16 after sums in another order.
    f32: 1e-4 of it, tests/test_pallas.py's bound on the Pallas gradients."""
    rel = 4 * 2**-8 if dtype == torch.bfloat16 else 1e-4
    return rel * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,dtype,exact", [
    (8 * 192, 768, torch.bfloat16, False),
    (3 * 192 + 7, 768, torch.bfloat16, True),  # ragged, erf GELU
    (5 * 192 + 3, 384, torch.bfloat16, False),
    (4 * 192 + 3, 1024, torch.bfloat16, False),
    (2 * 192 + 5, 1280, torch.bfloat16, False),
    (97, 768, torch.bfloat16, True),  # less than one 128-row tile
    (2 * 192 + 7, 768, torch.float32, False),
    (97, 1024, torch.float32, True),
])
def test_fused_ln_mlp_backward_kernel(cuda_device, R, C, dtype, exact):
    g = torch.Generator(device=cuda_device).manual_seed(8)
    args = mlp_args(g, R, C, dtype, cuda_device)
    dout = torch.randn(R, C, generator=g, device=cuda_device).to(dtype)
    before = fused_ln_mlp_backward.launches
    grads = fused_ln_mlp_backward(*args, dout, exact)
    again = fused_ln_mlp_backward(*args, dout, exact)
    torch.cuda.synchronize()
    assert fused_ln_mlp_backward.launches == before + 2
    refs = fused_ln_mlp_bwd_reference(*args, dout, exact)
    twins = fused_ln_mlp_bwd_kernel_order_reference(*args, dout, exact)
    for name, got, rerun, ref, twin, arg in zip(
            ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2"), grads, again, refs, twins, args):
        assert got.dtype == arg.dtype and got.shape == arg.shape, name
        assert torch.equal(got, rerun), name  # no atomics: two runs, the same bits
        assert max_err(got, ref) <= grad_bound(ref, dtype), name
        if dtype == torch.bfloat16:
            # the plain backward in the kernel's order (du rounded, one f32
            # sum): two bf16 ulps (2 * 2**-8) of each cotangent's magnitude
            assert max_err(got, twin) <= 2 * 2**-8 * twin.float().abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 97, 3 * 192 + 7, 12288])
@pytest.mark.parametrize("C", SUPPORTED_WIDTHS)
def test_mlp_workspace_bytes_match_the_library(cuda_device, C, R):
    """The Python count of the bf16 backward's scratch is the library's."""
    from probpose_pytorch_tpu_torch.ops.kernels.mlp import _lib

    for Hd in (4 * C, 1280, 2048):
        assert _lib().fused_mlp_bwd_workspace_bytes(R, C, Hd) == mlp_workspace_bytes(R, C, Hd)


@pytest.mark.cuda
@pytest.mark.parametrize("C,hidden", [
    (384, 1280),  # 192 does not divide the hidden width: blocks of 128 x 128
    (768, 2048),  # nor here: 128 x 256
])
def test_fused_ln_mlp_kernels_at_other_hidden_widths(cuda_device, C, hidden):
    """bf16 forward and backward at hidden widths other than 4 C (a multiple
    of 256 that 192 does not divide), against the plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    R = 2 * 192 + 9
    args = mlp_args(g, R, C, torch.bfloat16, cuda_device, hidden)
    out = fused_ln_mlp(*args)
    ref = fused_ln_mlp_reference(*args)
    assert max_err(out, ref) <= bound(ref)
    dout = torch.randn(R, C, generator=g, device=cuda_device).to(torch.bfloat16)
    grads = fused_ln_mlp_backward(*args, dout)
    for name, got, ref, twin in zip(("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2"), grads,
                                    fused_ln_mlp_bwd_reference(*args, dout),
                                    fused_ln_mlp_bwd_kernel_order_reference(*args, dout)):
        assert max_err(got, ref) <= grad_bound(ref, torch.bfloat16), name
        assert max_err(got, twin) <= 2 * 2**-8 * twin.float().abs().max().item(), name


@pytest.mark.cuda
def test_fused_ln_mlp_autograd_on_card(cuda_device):
    """torch.autograd.grad through K5 runs the K5 backward once and gives
    what fused_ln_mlp_backward gives."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    args = mlp_args(g, 2 * 192, 768, torch.bfloat16, cuda_device)
    w = torch.randn(2 * 192, 768, generator=g, device=cuda_device).to(torch.bfloat16)
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    before = fused_ln_mlp_backward.launches
    grads = torch.autograd.grad((fused_ln_mlp(*leaves).float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    assert fused_ln_mlp_backward.launches == before + 1
    for got, want in zip(grads, fused_ln_mlp_backward(*args, w)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_ln_mlp_kernel_refuses_unsupported(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(10)
    x, scale, bias, w1, b1, w2, b2 = mlp_args(g, 16, 384, torch.bfloat16, cuda_device)
    with pytest.raises(TypeError):
        fused_ln_mlp(x.half(), scale, bias, w1.half(), b1, w2.half(), b2)
    x, scale, bias, w1, b1, w2, b2 = mlp_args(g, 16, 512, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="C=512"):
        fused_ln_mlp(x, scale, bias, w1, b1, w2, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,heads,d,dtype", [
    (16, 192, 12, 64, torch.bfloat16),  # ViT-B
    (3, 77, 4, 32, torch.bfloat16),
    (5, 96, 3, 48, torch.bfloat16),     # CUDA cores
    (4, 192, 6, 64, torch.float32),
])
def test_fused_attention_kernel(cuda_device, B, N, heads, d, dtype):
    """K6 on the q, k, v views of a packed projection, as Attention gives
    them (no copy), and on contiguous (B, N, heads, d) tensors."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    qkv = torch.randn(B, N, 3 * heads * d, generator=g, device=cuda_device).to(dtype)
    views = qkv.unflatten(-1, (3, heads, d)).unbind(2)
    for q, k, v in (views, [t.contiguous() for t in views]):
        before = fused_attention.launches
        out = fused_attention(q, k, v)
        torch.cuda.synchronize()
        assert fused_attention.launches == before + 1
        ref = fused_attention_reference(q, k, v)
        assert max_err(out, ref) <= bound(ref)
    # K6 is K1's forward read through strides: the same bits
    assert torch.equal(out.reshape(B, N, heads * d), packed_attention(qkv, heads))


@pytest.mark.cuda
def test_fused_attention_gradient_raises_on_card(cuda_device):
    q, k, v = (torch.randn(2, 16, 2, 32, device=cuda_device, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    with pytest.raises(RuntimeError, match="forward only"):
        fused_attention(q, k, v).float().sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("attn_impl", ["fused", "pallas"])
def test_vitb_fused_mlp_forward_kernels_vs_plain(cuda_device, attn_impl):
    """Full-width ViT-B with mlp_impl="fused" in f32 (depth cut to 2): the
    kernel path against the plain path, with 2 K5 launches and 2 K1 (or,
    with attn_impl="pallas", 2 K6) launches per forward."""
    cfg = ModelConfig(backbone="vit-b", attn_impl=attn_impl, mlp_impl="fused",
                      compute_dtype="float32")
    model = build_model(cfg, cuda_device)
    del model.backbone.blocks[2:]
    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.rand(3, 256, 192, 3, generator=g, device=cuda_device)
    attn = fused_attention if attn_impl == "pallas" else packed_attention
    a0, m0 = attn.launches, fused_ln_mlp.launches
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
        assert (attn.launches - a0, fused_ln_mlp.launches - m0) == (2, 2)
        with plain_versions():
            ref = model(x)
    for o, r in zip(out, ref):
        # f32 everywhere; attention and MLP sums in another order.
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# K4 row-tiled attention, K3 fused decode, K2 at 192 x 192-pixel rows


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,heads,d,dtype", [
    (2, 1000, 6, 64, torch.bfloat16),   # not a multiple of the 64-key tile
    (2, 2304, 6, 64, torch.bfloat16),   # ViT-S on 768 x 768 inputs
    (2, 1000, 6, 64, torch.float32),
    (1, 2304, 6, 64, torch.float32),
    (3, 77, 2, 32, torch.bfloat16),
    (2, 130, 2, 128, torch.bfloat16),
    (2, 130, 2, 128, torch.float32),
    (2, 130, 8, 80, torch.bfloat16),    # d 80 (vit-h), on the CUDA cores
    (2, 130, 8, 80, torch.float32),
    (2, 129, 2, 32, torch.bfloat16),    # one key past a 128-key tile
    (2, 129, 2, 64, torch.bfloat16),
    (2, 129, 2, 128, torch.bfloat16),
    (3, 1, 2, 32, torch.bfloat16),      # a single token
    (3, 1, 2, 64, torch.bfloat16),
    (3, 1, 2, 128, torch.bfloat16),
    (4, 576, 12, 32, torch.bfloat16),   # vit-s-timm at 384 x 384: 4.5 tiles of 128 rows
])
def test_tiled_attention_kernels(cuda_device, B, N, heads, d, dtype):
    """K4 forward and backward against their plain versions; the backward
    gives the same bits twice (no atomics)."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    qkv = torch.randn(B, N, 3 * heads * d, generator=g, device=cuda_device).to(dtype)
    dout = torch.randn(B, N, heads * d, generator=g, device=cuda_device).to(dtype)
    f0, b0 = tiled_attention.launches, tiled_attention_backward.launches
    out = tiled_attention(qkv, heads)
    dqkv = tiled_attention_backward(qkv, dout, heads)
    again = tiled_attention_backward(qkv, dout, heads)
    torch.cuda.synchronize()
    assert (tiled_attention.launches - f0, tiled_attention_backward.launches - b0) == (1, 2)
    ref = tiled_attention_reference(qkv, heads)
    assert max_err(out, ref) <= bound(ref)
    dref = tiled_attention_bwd_reference(qkv, dout, heads)
    assert max_err(dqkv, dref) <= bound(dref)
    assert torch.equal(dqkv, again)


@pytest.mark.cuda
@pytest.mark.parametrize("N,d", [(2304, 64), (1000, 128), (129, 32), (576, 32)])
def test_tiled_attention_backward_with_saved_residuals(cuda_device, N, d):
    """bf16: the forward's lse matches the kernel-order plain version, and
    the backward from the saved (out, lse) gives the same bits as the one
    that makes them itself."""
    g = torch.Generator(device=cuda_device).manual_seed(18)
    heads = 384 // d
    qkv = torch.randn(2, N, 3 * heads * d, generator=g, device=cuda_device).to(torch.bfloat16)
    dout = torch.randn(2, N, heads * d, generator=g, device=cuda_device).to(torch.bfloat16)
    out, lse = tiled_forward(qkv, heads, with_lse=True)
    assert lse.shape == (2, heads, N) and lse.dtype == torch.float32
    assert torch.equal(out, tiled_forward(qkv, heads)[0])  # lse changes nothing of out
    _, lse_ref = tiled_attention_online_reference(qkv, heads)
    assert (lse - lse_ref).abs().max().item() <= 1e-5 * lse_ref.abs().max().item()
    saved = tiled_attention_backward(qkv, dout, heads, out, lse)
    assert torch.equal(saved, tiled_attention_backward(qkv, dout, heads))


@pytest.mark.cuda
def test_packed_attention_k4_route_saves_lse(cuda_device):
    """On K4's bf16 route the autograd Function saves (qkv, out, lse), and
    one forward and one backward kernel run per call: the backward reads
    the saved residuals and runs no forward of its own, which a call
    without them does."""
    g = torch.Generator(device=cuda_device).manual_seed(19)
    qkv = torch.randn(2, 2304, 1152, generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn(2, 2304, 384, generator=g, device=cuda_device).to(torch.bfloat16)
    x = qkv.clone().requires_grad_(True)
    f0, b0 = tiled_attention.launches, tiled_attention_backward.launches
    r0 = tiled_attention_backward.recomputes
    y = packed_attention(x, 6)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 3 and saved[1] is not None and saved[2].shape == (2, 6, 2304)
    assert torch.equal(saved[1], y)
    (grad,) = torch.autograd.grad((y.float() * w.float()).sum(), x)
    torch.cuda.synchronize()
    assert (tiled_attention.launches - f0, tiled_attention_backward.launches - b0) == (1, 1)
    assert tiled_attention_backward.recomputes == r0
    assert torch.equal(grad, tiled_attention_backward(qkv, w, 6))
    assert tiled_attention_backward.recomputes == r0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("N,dtype,route,bwd_route", [
    (192, torch.bfloat16, "sm90 short", "sm90 tiled"),
    (192, torch.float32, "K1 CUDA cores", "K1 CUDA cores"),
    (2304, torch.bfloat16, "sm90 tiled", "sm90 tiled"),
    (2304, torch.float32, "K4 CUDA cores", "K4 CUDA cores"),
])
def test_packed_attention_routes_by_shape(cuda_device, N, dtype, route, bwd_route):
    """packed_attention runs the kernel its route names, forward and
    backward, and autograd goes through the routed kernels."""
    assert kernel_path(N, 64, dtype) == route
    assert kernel_path(N, 64, dtype, backward=True) == bwd_route
    g = torch.Generator(device=cuda_device).manual_seed(14)
    qkv = torch.randn(2, N, 1152, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(2, N, 384, generator=g, device=cuda_device).to(dtype)
    counts = lambda: (packed_attention.launches, packed_attention_backward.launches,
                      short_forward.launches, tiled_attention.launches,
                      tiled_attention_backward.launches)
    c0 = counts()
    x = qkv.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad((packed_attention(x, 6).float() * w.float()).sum(), x)
    torch.cuda.synchronize()
    want = {"sm90 short": (0, 0, 1, 0, 1), "K1 CUDA cores": (1, 1, 0, 0, 0)}.get(
        route, (0, 0, 0, 1, 1))
    assert tuple(a - b for a, b in zip(counts(), c0)) == want
    k4 = route != "K1 CUDA cores"
    ref = (tiled_attention_bwd_reference if k4 else packed_attention_bwd_reference)(qkv, w, 6)
    assert max_err(grad, ref) <= bound(ref)


@pytest.mark.cuda
def test_packed_attention_k1_forward_k4_backward(cuda_device):
    """Where K1's forward and backward take different kernels (bf16, N <=
    256: the short forward, K4's backward), autograd saves (qkv, out, lse),
    runs one of each, and the backward reads the saved residuals and runs
    no forward of its own."""
    N, heads, d = 200, 2, 64
    assert kernel_path(N, d, torch.bfloat16) == "sm90 short"
    assert kernel_path(N, d, torch.bfloat16, backward=True) == "sm90 tiled"
    g = torch.Generator(device=cuda_device).manual_seed(15)
    qkv = torch.randn(2, N, 3 * heads * d, generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn(2, N, heads * d, generator=g, device=cuda_device).to(torch.bfloat16)
    f0, b0 = short_forward.launches, tiled_attention_backward.launches
    r0 = tiled_attention_backward.recomputes
    x = qkv.clone().requires_grad_(True)
    y = packed_attention(x, heads)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 3 and torch.equal(saved[1], y) and saved[2].shape == (2, heads, N)
    (grad,) = torch.autograd.grad((y.float() * w.float()).sum(), x)
    torch.cuda.synchronize()
    assert (short_forward.launches - f0, tiled_attention_backward.launches - b0) == (1, 1)
    assert tiled_attention_backward.recomputes == r0
    assert torch.equal(grad, tiled_attention_backward(qkv, w, heads, saved[1], saved[2]))
    ref = packed_attention_bwd_reference(qkv, w, heads)
    assert max_err(grad, ref) <= bound(ref)


# --------------------------------------------------------------------------
# K1's bf16 route on the wgmma kernels: the short forward, K4's backward


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,heads,d", [
    (256, 192, 6, 64),   # the flagship's batch
    (5, 200, 2, 64),     # keys padded to 256
    (5, 77, 4, 32),
    (4, 192, 2, 128),
])
def test_short_forward_and_backward_kernels(cuda_device, B, N, heads, d):
    """The short forward against the TPU-order plain version (context and
    lse); the backward from its saved (out, lse) against the TPU-order
    plain backward and the kernel-order one, the same bits twice."""
    g = torch.Generator(device=cuda_device).manual_seed(20)
    qkv = torch.randn(B, N, 3 * heads * d, generator=g, device=cuda_device).to(torch.bfloat16)
    dout = torch.randn(B, N, heads * d, generator=g, device=cuda_device).to(torch.bfloat16)
    f0 = short_forward.launches
    out, lse = short_forward(qkv, heads, with_lse=True)
    torch.cuda.synchronize()
    assert short_forward.launches == f0 + 1
    ref, lse_ref = short_attention_reference(qkv, heads)
    assert max_err(out, ref) <= bound(ref)
    assert torch.equal(out, short_forward(qkv, heads)[0])  # lse changes nothing of out
    assert (lse - lse_ref).abs().max().item() <= 1e-5 * max(1.0, lse_ref.abs().max().item())
    got = packed_attention_backward(qkv, dout, heads, out, lse)
    again = packed_attention_backward(qkv, dout, heads, out, lse)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # no atomics
    dref = packed_attention_bwd_reference(qkv, dout, heads)
    assert max_err(got, dref) <= bound(dref)
    oref = tiled_attention_online_bwd_reference(qkv, dout, heads, out, lse)
    assert max_err(got, oref) <= bound(oref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_vith_long_sequence_runs_k4_cuda_cores(cuda_device, dtype):
    """qkv (1, 672, 3840) with 16 heads (vit-h, d = 80, on 448 x 384 crops),
    past K1's shared memory: packed_attention's forward and autograd.grad
    launch K4's CUDA-core kernels once each and meet the K1 bound against
    the plain versions in the TPU kernels' order."""
    g = torch.Generator(device=cuda_device).manual_seed(22)
    qkv = torch.randn(1, 672, 3840, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(1, 672, 1280, generator=g, device=cuda_device).to(dtype)
    assert kernel_path(672, 80, dtype) == kernel_path(672, 80, dtype, True) == "K4 CUDA cores"
    f0, b0 = tiled_attention.launches, tiled_attention_backward.launches
    x = qkv.clone().requires_grad_(True)
    y = packed_attention(x, 16)
    (grad,) = torch.autograd.grad((y.float() * w.float()).sum(), x)
    torch.cuda.synchronize()
    assert (tiled_attention.launches - f0, tiled_attention_backward.launches - b0) == (1, 1)
    ref = tiled_attention_reference(qkv, 16)
    assert max_err(y, ref) <= bound(ref)
    dref = tiled_attention_bwd_reference(qkv, w, 16)
    assert max_err(grad, dref) <= bound(dref)
    assert torch.equal(grad, packed_attention_backward(qkv, w, 16))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,dtype", [
    (192, 64, torch.float32), (96, 48, torch.bfloat16), (645, 80, torch.bfloat16),
    (646, 80, torch.bfloat16), (340, 80, torch.float32), (2304, 64, torch.float32),
])
def test_k1_smem_bytes_match_the_library(cuda_device, N, d, dtype):
    """The route's count of K1's CUDA-core shared memory is the library's."""
    from probpose_pytorch_tpu_torch.ops.kernels.attention import _lib

    code = 0 if dtype == torch.float32 else 1
    assert _lib().packed_attention_smem_bytes(N, d, code) == k1_smem_bytes(N, d, dtype)
    assert _lib().packed_attention_bwd_smem_bytes(N, d, code) == k1_smem_bytes(N, d, dtype)


def _peaked_maps(g, B, K, H, W, device):
    yy, xx = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                            indexing="ij")
    c = torch.rand(B, K, 2, 1, 1, generator=g, device=device) * torch.tensor(
        [W - 8.0, H - 8.0], device=device).reshape(2, 1, 1) + 4
    maps = torch.exp(-((xx - c[:, :, 0]) ** 2 + (yy - c[:, :, 1]) ** 2) / (2 * (H / 32) ** 2))
    return maps + 0.03 * torch.rand(B, K, H, W, generator=g, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,H,W,operators", [(64, 17, 64, 48, "oks"), (8, 17, 192, 192, "oks"),
                                               (3, 5, 100, 70, "oks"), (4, 17, 64, 48, "coco"),
                                               (2, 17, 192, 192, "coco"), (2, 3, 24, 20, "dense")])
def test_fused_decode_kernel(cuda_device, B, K, H, W, operators):
    """K3 against the plain decode and its banded twin: 1e-3 px, raw values
    1e-6, and bit-identical across two runs. The OKS operators at sigma
    0.05 (chip_smoke.py's), at the COCO sigmas (band radii 2 to 9 in one
    launch), and dense random operators (band radius n - 1); 100 x 70 maps
    (rows of 280 bytes) are staged without bulk copies, and 192 x 192 maps
    run in strips."""
    g = torch.Generator(device=cuda_device).manual_seed(16)
    maps = _peaked_maps(g, B, K, H, W, cuda_device)
    if operators == "dense":
        row_op = torch.rand(K, H, H, generator=g, device=cuda_device) / H
        col_op = torch.rand(K, W, W, generator=g, device=cuda_device) / W
    else:
        sigmas = COCO_SIGMAS[:K] if operators == "coco" else [0.05] * K
        ops = build_oks_conv_operators(sigmas, H, W)
        row_op = torch.from_numpy(ops.row_op).to(cuda_device)
        col_op = torch.from_numpy(ops.col_op).to(cuda_device)
    before = expected_value_decode_fused.launches
    locs, vals = expected_value_decode_fused(maps, row_op, col_op)
    again = expected_value_decode_fused(maps, row_op, col_op)
    torch.cuda.synchronize()
    assert expected_value_decode_fused.launches == before + 2
    for ref_locs, ref_vals in (expected_value_decode(maps, row_op, col_op),
                               expected_value_decode_banded_reference(maps, row_op, col_op)):
        assert max_err(locs, ref_locs) <= 1e-3
        assert max_err(vals, ref_vals) <= 1e-6
    assert torch.equal(locs, again[0]) and torch.equal(vals, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("R", [32 * 17, 17 * 3 + 5])
def test_sparsemax_kernel_long_rows(cuda_device, R):
    """K2 on 192 x 192-pixel rows, staged in shared memory, and on a view
    whose rows start off 16-byte boundaries (no bulk copies)."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    z = torch.randn(R, 192 * 192 + 1, generator=g, device=cuda_device) / 0.5
    check_sparsemax(z[:, :-1].contiguous())
    check_sparsemax(z.flatten()[1:1 + R * 192 * 192].view(R, 192 * 192))


def _recipe_config(**aug):
    from probpose_pytorch_tpu_torch.train.config import AugmentConfig, OptimConfig, TrainConfig

    model = ModelConfig(img_size=(64, 48), num_keypoints=17, backbone="vit-nano",
                        compute_dtype="float32", deconv_out_channels=(16, 16),
                        pool_sizes=((2, 2), (2, 2)), attn_impl="fused")
    return TrainConfig(model=model, augment=AugmentConfig(**aug), train_batch_size=8,
                       optim=OptimConfig(ema_decay=0.999, max_nonfinite_skips=5))


def _frame_batch(rng, B, K):
    boxes = np.concatenate([rng.uniform(0, 60, (B, 2)), rng.uniform(40, 100, (B, 2))], 1)
    return dict(frame=rng.integers(0, 256, (B, 160, 200, 3), dtype=np.uint8),
                box=boxes.astype(np.float32),
                keypoints=(boxes[:, None, :2] + rng.random((B, K, 2)) * boxes[:, None, 2:])
                .astype(np.float32),
                keypoints_visible=np.ones((B, K), np.float32),
                keypoints_visibility=(rng.random((B, K)) > 0.1).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["crop", "frame"])
def test_augmented_preamble_on_card_matches_cpu(cuda_device, mode):
    """The same draws through train/loop.py:augment_batch and the target
    encode on the card and on the CPU (half-body and rotation on). Crops:
    1e-5 in crop mode; in frame mode one bf16 ulp of a value <= 1 times
    up to 1 + contrast (crop_resize rounds to bf16, cuBLAS sums in another
    order). Keypoints within 1e-3 px, heatmaps within 1e-5."""
    from probpose_pytorch_tpu_torch.ops.augment import draw_augment
    from probpose_pytorch_tpu_torch.train.loop import _encode_targets, augment_batch, build_codecs

    cfg = _recipe_config(half_body_prob=0.5, rotation_deg=30.0)
    H, W = cfg.model.img_size
    B, K = 16, 17
    rng = np.random.default_rng(3)
    if mode == "crop":
        batch = dict(image=rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
                     keypoints=rng.uniform(-5, 60, (B, K, 2)).astype(np.float32),
                     keypoints_visible=np.ones((B, K), np.float32),
                     keypoints_visibility=(rng.random((B, K)) > 0.2).astype(np.float32))
    else:
        batch = _frame_batch(rng, B, K)
    draws = draw_augment(cfg.seed, 5, B, cfg.augment, "cpu")
    assert bool((draws.half_u < 0.5).any())
    enc, _ = build_codecs(cfg)
    host = {k: torch.as_tensor(v) for k, v in batch.items()}
    img_c, b_c = augment_batch(cfg, host, draws)
    img_g, b_g = augment_batch(cfg, {k: v.to(cuda_device) for k, v in host.items()},
                               draws.to(cuda_device))
    hm_c = _encode_targets(enc, b_c)["heatmaps"]
    hm_g = _encode_targets(enc, b_g)["heatmaps"]
    torch.cuda.synchronize()
    assert img_g.is_cuda and hm_g.is_cuda
    assert max_err(img_g.cpu(), img_c) <= (1e-5 if mode == "crop" else 2.0**-7)
    assert (img_g.cpu() - img_c).abs().mean().item() <= 1e-5
    assert max_err(b_g["keypoints"].cpu(), b_c["keypoints"]) <= 1e-3
    assert max_err(hm_g.cpu(), hm_c) <= 1e-5


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A state on the card after two augmented steps saves and restores into
    a fresh trainer on the card bit for bit."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.train.checkpoint import CheckpointManager
    from probpose_pytorch_tpu_torch.train.loop import Trainer

    cfg = _recipe_config()
    a = Trainer.create(cfg, 10, device=cuda_device)
    batches = list(batch_iterator(SyntheticPoseDataset(16, (64, 48), 17, seed=1), 8,
                                  num_workers=1))
    for batch in batches:
        a.train_step(a.state, a.device_batch(batch))
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(a.state.host_step, a.state)
    b = Trainer.create(cfg, 10, device=cuda_device)
    mgr.restore(b.state)

    def tensors(t):
        s = t.state
        return (list(s.params) + list(s.ema_params) + list(t.model.buffers()) + list(s.opt_state.mu)
                + list(s.opt_state.nu) + [s.opt_state.count, s.opt_state.schedule_count, s.step])

    pairs = list(zip(tensors(a), tensors(b)))
    assert len(pairs) > 100
    for x, y in pairs:
        assert y.is_cuda and torch.equal(x, y)
    assert b.state.host_step == a.state.host_step == 2


@pytest.mark.cuda
def test_predictor_tta_kernels_vs_plain(cuda_device):
    """The full-width ViT-S predictor in f32 with flip test, three scales
    and temperatures: through the kernels against the same predictor
    through the plain versions, keypoints within the card's 1e-2 px on
    every keypoint whose OKS-convolved map has a top-2 margin above 1e-4
    at each scale; the K1 and K2 launches 12 and 1 per forward (2 x 3
    forwards)."""
    from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor, _scale_boxes
    from probpose_pytorch_tpu_torch.ops.heatmap import oks_conv

    cfg = ModelConfig(attn_impl="fused", compute_dtype="float32")
    model = build_model(cfg, cuda_device, seed=3)
    _peak_heatmap_branch(model)
    codec = Codec(ProbMap((192, 256), (48, 64), sigmas=np.full(17, 0.05, np.float32),
                          sigma=2.0))
    scales = (0.9, 1.0, 1.1)
    pred = TopDownPredictor(model, codec, (256, 192), flip_test=True, scale_test=scales,
                            calibration={"presence": 1.7, "visibility": 0.6})
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, size=(4, 320, 256, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 120, 180], [60, 60, 196, 260], (4, 4)).astype(np.float32)
    f0, s0 = forward_launches(), sparsemax_rows.launches
    out = pred(frames, boxes)
    assert (forward_launches() - f0, sparsemax_rows.launches - s0) == (12 * 6, 6)
    with plain_versions():
        ref = pred(frames, boxes)
        one = TopDownPredictor(model, codec, (256, 192), flip_test=True, return_heatmaps=True)
        maps = [one(frames, _scale_boxes(torch.from_numpy(boxes), s).numpy())["heatmaps"]
                for s in scales]
    row_op, col_op = codec.probmap.conv_operators(cuda_device)
    ok = np.ones((4, 17), bool)
    for hm in maps:
        conv = oks_conv(torch.from_numpy(hm).to(cuda_device), row_op, col_op)
        top2 = conv.flatten(2).topk(2).values
        ok &= ((top2[..., 0] - top2[..., 1]) > 1e-4).cpu().numpy()
    assert ok.mean() > 0.5
    for k in out:
        assert out[k].shape == ref[k].shape and np.isfinite(out[k]).all(), k
    np.testing.assert_allclose(out["keypoints"][ok], ref["keypoints"][ok], atol=1e-2)
    for k in ("probabilities", "visibilities", "oks", "errors"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.cuda
def test_short_forward_with_one_prefix_token(cuda_device):
    """The frozen RADIO recipe's attention: ViT-B with one prefix token,
    N = 193 (a ragged row past 192), 12 heads of d = 64, bf16, on the short
    forward, against its plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    qkv = torch.randn(64, 193, 3 * 768, generator=g, device=cuda_device).to(torch.bfloat16)
    assert kernel_path(193, 64, torch.bfloat16) == "sm90 short"
    before = short_forward.launches
    out = packed_attention(qkv, 12)
    torch.cuda.synchronize()
    assert short_forward.launches == before + 1
    ref = packed_attention_reference(qkv, 12)
    assert max_err(out, ref) <= bound(ref)


def _small_trainers(cuda_device, **over):
    """Two trainers of a ViT-S-width, depth-2 float32 config with `over`,
    heatmap branches peaked alike, and a synthetic batch of 8."""
    from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
    from probpose_pytorch_tpu_torch.models.vit import ViTConfig
    from probpose_pytorch_tpu_torch.train.config import TrainConfig
    from probpose_pytorch_tpu_torch.train.loop import Trainer

    ViTConfig.PRESETS.setdefault("vit-s-depth2", dict(ViTConfig.PRESETS["vit-s"], depth=2))
    model = dict(img_size=(256, 192), num_keypoints=17, backbone="vit-s-depth2",
                 compute_dtype="float32", attn_impl="fused", pool_sizes=((4, 3), (2, 2), (2, 2)))
    model.update(over.pop("model", {}))
    cfg = TrainConfig.from_dict(dict(model=model, optim=dict(ema_decay=0.999,
                                                             max_nonfinite_skips=5),
                                     epochs=10, resume=False, **over))
    ds = SyntheticPoseDataset(8, (256, 192), 17)
    batch = next(iter(batch_iterator(ds, 8, num_workers=1)))
    trainers = [Trainer.create(cfg, 1, cuda_device) for _ in range(2)]
    for t in trainers:
        _peak_heatmap_branch(t.model)
    return trainers, batch


@pytest.mark.cuda
def test_lora_step_kernels_vs_plain(cuda_device):
    """A LoRA-only f32 step (rank 8 at all four sites, ViT-S width, depth
    2) through the kernels against the plain versions: 2 K1 forward, 2 K1
    backward (whose dqkv the qkv delta's products consume) and 1 K2; loss
    1e-5 and grad_norm 1e-4 relative; frozen tensors unchanged on both
    paths, trainable ones within Adam's 2 lr."""
    from probpose_pytorch_tpu_torch.train.loop import frozen_labels

    trainers, batch = _small_trainers(cuda_device, model=dict(lora_rank=8),
                                      train_lora_only=True)
    start = [p.detach().clone() for p in trainers[0].state.params]
    f0, b0, s0 = forward_launches(), backward_launches(), sparsemax_rows.launches
    _, mk = trainers[0].train_step(trainers[0].state, trainers[0].device_batch(batch))
    torch.cuda.synchronize()
    assert (forward_launches() - f0, backward_launches() - b0,
            sparsemax_rows.launches - s0) == (2, 2, 1)
    with plain_versions():
        _, mp = trainers[1].train_step(trainers[1].state, trainers[1].device_batch(batch))
    for key in mp:
        rtol = 1e-4 if key == "grad_norm" else 1e-5
        torch.testing.assert_close(mk[key], mp[key], rtol=rtol, atol=1e-12, msg=key)
    lr = float(trainers[0].tx.schedule(torch.zeros((), dtype=torch.int32)))
    labels = frozen_labels(trainers[0].cfg, trainers[0].state.names)
    for lab, s, a, b in zip(labels, start, trainers[0].state.params, trainers[1].state.params):
        if lab == "frozen":
            assert torch.equal(a, s) and torch.equal(b, s)
        else:
            assert (a - b).abs().max().item() <= 2 * lr


@pytest.mark.cuda
def test_frozen_trunk_step_runs_no_attention_backward(cuda_device):
    """The frozen RADIO recipe's step at depth 2 (frozen trunk, one prefix
    token, exact GELU, an adapter): the detached trunk's attention runs
    forward only; the trunk stays bit-identical, the adapter moves."""
    trainers, batch = _small_trainers(cuda_device, model=dict(
        frozen_backbone=True, num_prefix_tokens=1, exact_gelu=True, adapter_hidden=(384,)))
    t = trainers[0]
    start = [p.detach().clone() for p in t.state.params]
    f0, b0 = forward_launches(), backward_launches()
    _, metrics = t.train_step(t.state, t.device_batch(batch))
    torch.cuda.synchronize()
    assert (forward_launches() - f0, backward_launches() - b0) == (2, 0)
    assert bool(torch.isfinite(metrics["loss"]))
    for name, s, p in zip(t.state.names, start, t.state.params):
        trunk = name.startswith("backbone.") and "adapters" not in name
        if trunk:
            assert torch.equal(p, s), name
        elif name.startswith("backbone.adapters."):
            assert not torch.equal(p, s), name


# --------------------------------------------------------------------------
# the detector family (models/convnet.py, detect/) on the card


def _detector(seed, **kw):
    from probpose_pytorch_tpu_torch.detect.model import PersonDetector, init_detector_weights

    model = PersonDetector(dtype=torch.float32, **kw)
    init_detector_weights(model, torch.Generator().manual_seed(seed))
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_detector_forward_on_card_matches_cpu(cuda_device, train):
    """The f32 detector (conv-t, joint heat heads) at 128 x 128, TF32 off:
    every map on the card within 1e-5 (eval) or 1e-4 (train: BatchNorm of a
    batch of 2 magnifies summation order) of the CPU's, normwise."""
    import copy

    cpu = _detector(0, img_size=(128, 128), num_keypoints=17, kpt_heatmaps=True).train(train)
    card = copy.deepcopy(cpu).to(cuda_device).train(train)
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref, out = cpu(x), card(x.to(cuda_device))
    tol = 1e-4 if train else 1e-5
    for k in ref:
        rel = ((out[k].cpu() - ref[k]).norm() / ref[k].norm()).item()
        assert rel <= tol, (k, rel)
    if train:
        for (n, a), b in zip(cpu.named_buffers(), card.buffers()):
            if a.is_floating_point():
                torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-5, msg=n)


def _tied_maps(B=2, H=16, W=16, Kj=5):
    """Center logits with ties (a low random background whose non-peaks
    decode to exactly 0.0, a plateau of equal peaks, two equal isolated
    peaks) and the pose maps, as tests/test_torch_detect.py builds them."""
    g = torch.Generator().manual_seed(3)
    c = -8.0 + 0.5 * torch.randn(B, H, W, 1, generator=g)
    c[0, 2, 3] = c[0, 9, 12] = 1.5
    c[0, 5:7, 5:7] = 0.7
    heat = -6.0 + 0.5 * torch.randn(B, H, W, Kj, generator=g)
    heat[0, 7:9, 4:6, 0] = 2.0
    heat[:, ::5, ::3, :] = 1.0
    return dict(center_logits=c, size=torch.rand(B, H, W, 2, generator=g) * 6,
                offset=torch.rand(B, H, W, 2, generator=g),
                kpts=torch.randn(B, H, W, 2 * Kj, generator=g) * 2, kpt_heat=heat,
                kpt_offset=torch.rand(B, H, W, 2, generator=g))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 40])
def test_decode_on_card_keeps_the_tie_order(cuda_device, k):
    """decode_boxes and decode_poses on the card equal the CPU's on maps
    with ties: lax.top_k's order (the lower index first), not torch.topk's,
    so the boxes and poses are equal; the scores within two ulps."""
    from probpose_pytorch_tpu_torch.detect.codec import decode_boxes, decode_poses

    maps = _tied_maps()
    card = {n: v.to(cuda_device) for n, v in maps.items()}
    box_keys = ("center_logits", "size", "offset")
    (boxes, scores), (rb, rs) = (decode_boxes(*(card[n] for n in box_keys), k=k),
                                 decode_boxes(*(maps[n] for n in box_keys), k=k))
    # the peaks' cells decide the boxes: equal; the scores are sigmoids,
    # whose CUDA and CPU versions may differ by an ulp
    assert torch.equal(boxes.cpu(), rb)
    torch.testing.assert_close(scores.cpu(), rs, rtol=2.4e-7, atol=0)
    got, want = decode_poses(**card, k=k), decode_poses(**maps, k=k)
    for i, (o, r) in enumerate(zip(got, want)):
        if i in (0, 2):  # boxes and poses
            assert torch.equal(o.cpu(), r)
        else:
            torch.testing.assert_close(o.cpu(), r, rtol=2.4e-7, atol=0)


def _pose_predictor(device, dtype="float32"):
    from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor

    cfg = ModelConfig(img_size=(64, 48), num_keypoints=17, backbone="vit-nano",
                      compute_dtype=dtype, attn_impl="fused", deconv_out_channels=(16, 16),
                      pool_sizes=((2, 2), (2, 2)))
    codec = Codec(ProbMap(input_size=(64, 48), heatmap_size=(12, 16),
                          sigmas=np.asarray(COCO_SIGMAS, np.float32), sigma=2.0))
    model = build_model(cfg, "cpu", seed=3)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():  # head kernels at fan-in scale: peaked, sparse maps
        for m in model.head.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / m.weight[0].numel() ** 0.5)
    return TopDownPredictor(model=model.to(device), codec=codec, input_size=(64, 48))


@pytest.mark.cuda
def test_fused_matches_two_stage_on_card(cuda_device):
    """FusedTwoStagePredictor against TopDownPredictor(detector=...) on the
    same frames (f32, threshold 0): each slot's well-defined keypoints
    within 1e-2 px of the two-stage pose for its box; the fused device path runs without a
    host synchronisation; K1 and K2 run in its pose stage."""
    from probpose_pytorch_tpu_torch.detect import DetectorPredictor, FusedTwoStagePredictor

    det = DetectorPredictor(model=_detector(5, img_size=(64, 64)).to(cuda_device),
                            max_detections=8, score_threshold=0.0)
    det.model.size.bias.data.fill_(6.0)
    pose = _pose_predictor(cuda_device)
    fused = FusedTwoStagePredictor(detector=det, pose=pose, max_people=4, score_threshold=0.0)
    frames = np.random.default_rng(0).integers(0, 256, (2, 120, 160, 3), dtype=np.uint8)
    out = fused(frames)
    pose.detector, pose.return_heatmaps = det, True
    row_op, col_op = pose.codec.probmap.conv_operators(cuda_device)
    for b in range(2):
        two = pose.predict_frame(frames[b], buckets=(8,), detector_threshold=0.0)
        np.testing.assert_allclose(out["boxes"][b], two["boxes"][:4], rtol=0, atol=1e-3)
        # keypoints whose OKS-convolved map has a top-2 margin above 1e-4
        conv = oks_conv(torch.from_numpy(two["heatmaps"][:4]).to(cuda_device), row_op, col_op)
        top2 = conv.flatten(2).topk(2, dim=-1).values
        ok = ((top2[..., 0] - top2[..., 1]) > 1e-4).cpu().numpy()
        assert ok.mean() > 0.5
        np.testing.assert_allclose(out["keypoints"][b][ok], two["keypoints"][:4][ok], rtol=0,
                                   atol=1e-2)
    pose.return_heatmaps = False
    dev = torch.as_tensor(frames).to(cuda_device)
    torch.cuda.synchronize()
    k1, k2 = forward_launches(), sparsemax_rows.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = fused.predict(dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert res["keypoints"].shape == (2, 4, 17, 2)
    assert forward_launches() - k1 == len(pose.model.backbone.blocks)
    assert sparsemax_rows.launches - k2 == 1


@pytest.mark.cuda
def test_detect_entry_points_default_to_the_card(cuda_device, tmp_path):
    """DetectorTrainer.create, the detect CLI, load_detector and
    load_bottomup build on the card when no device is named."""
    from probpose_pytorch_tpu_torch.data import generate_coco_synth
    from probpose_pytorch_tpu_torch.detect import DetectorTrainer, load_bottomup, load_detector
    from probpose_pytorch_tpu_torch.detect import train as detect_train

    assert DetectorTrainer.create(img_size=(64, 64)).state.params[0].is_cuda
    root = generate_coco_synth(tmp_path / "coco", n_train_images=2, n_val_images=1,
                               frame_hw=(96, 128), seed=1)
    common = ["--data-root", str(root), "--steps", "1", "--batch-size", "2", "--img-size", "64",
              "--num-workers", "1"]
    detect_train.main(common + ["--out", str(tmp_path / "det")])
    detect_train.main(common + ["--out", str(tmp_path / "bu"), "--keypoints", "17"])
    assert next(load_detector(tmp_path / "det" / "checkpoints").model.parameters()).is_cuda
    assert next(load_bottomup(tmp_path / "bu").model.parameters()).is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["short", "tiled", "packed", "flat", "mlp", "sparsemax"])
def test_serving_ops_match_their_wrappers(cuda_device, op):
    """Each `probpose::` op called directly launches the kernel its wrapper
    launches: the same bits, one count on the same wrapper, and the op's
    fake implementation's shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator(device=cuda_device).manual_seed(0)
    rnd = lambda *s, dtype=torch.bfloat16: torch.randn(  # noqa: E731
        s, generator=g, device=cuda_device).to(dtype)
    if op in ("short", "tiled", "packed"):
        shape, heads, dtype = {"short": ((8, 192, 1152), 6, torch.bfloat16),
                               "tiled": ((2, 576, 1152), 6, torch.bfloat16),
                               "packed": ((4, 192, 1152), 6, torch.float32)}[op]
        x = rnd(*shape, dtype=dtype)
        counter = {"short": short_forward, "tiled": tiled_attention,
                   "packed": packed_attention}[op]
        name = {"short": "short_attention_fwd", "tiled": "tiled_attention_fwd",
                "packed": "packed_attention_fwd"}[op]
        args = (x, heads) if op == "packed" else (x, heads, False)
        want = packed_attention(x, heads) if op != "tiled" else tiled_attention(x, heads)
    elif op == "flat":
        q, k, v = (rnd(16, 192, 12, 64) for _ in range(3))
        counter, name, args, want = fused_attention, "flat_attention_fwd", (q, k, v), \
            fused_attention(q, k, v)
    elif op == "mlp":
        x = rnd(1024, 768)
        vecs = [rnd(768, dtype=torch.float32), rnd(768, dtype=torch.float32)]
        w1, b1 = rnd(768, 3072) * 0.03, rnd(3072, dtype=torch.float32)
        w2, b2 = rnd(3072, 768) * 0.03, rnd(768, dtype=torch.float32)
        args = (x, *vecs, w1, b1, w2, b2, False)
        counter, name, want = fused_ln_mlp, "fused_ln_mlp_fwd", fused_ln_mlp(*args)
    else:
        z = rnd(17 * 8, 3072, dtype=torch.float32)
        counter, name, args, want = sparsemax_rows, "sparsemax_rows", (z,), sparsemax_rows(z)
    before = counter.launches
    got = getattr(torch.ops.probpose, name)(*args)
    torch.cuda.synchronize()
    got = got[0] if isinstance(got, tuple) else got
    assert counter.launches == before + 1
    assert torch.equal(got, want)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = getattr(torch.ops.probpose, name)(*(mode.from_tensor(a) if isinstance(
            a, torch.Tensor) else a for a in args))
    fake = fake[0] if isinstance(fake, tuple) else fake
    assert fake.shape == got.shape and fake.dtype == got.dtype
    assert counter.launches == before + 1


@pytest.mark.cuda
def test_card_bundle_holds_the_ops_and_matches_live(cuda_device, tmp_path):
    """vit-nano in bf16 with the fused attention, exported on the card: the
    graph holds K1's short forward and K2 as `probpose::` ops, the loaded
    bundle launches 2 (depth) K1 and 1 K2 per call and equals the live
    predictor at buckets 4 and 1; a dispatch does not synchronise."""
    import gzip
    import io

    from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.serve.export import ServingBundle, export_predictor_bundle

    model = build_model(ModelConfig(backbone="vit-nano", attn_impl="fused"), cuda_device, seed=2)
    _peak_heatmap_branch(model)
    codec = Codec(ProbMap((192, 256), (48, 64), sigmas=np.full(17, 0.05, np.float32),
                          sigma=2.0))
    live = TopDownPredictor(model, codec, (256, 192))
    out = export_predictor_bundle(live, tmp_path / "b", buckets=(1, 4), frame_shape=(320, 256))
    raw = gzip.decompress((out / "fn_b4.pt2.gz").read_bytes())
    graph = str(torch.export.load(io.BytesIO(raw)).graph)
    assert graph.count("probpose.short_attention_fwd") == 2
    assert graph.count("probpose.sparsemax_rows") == 1
    bundle = ServingBundle.load(out)
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, size=(4, 320, 256, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 120, 180], [60, 60, 196, 260], (4, 4)).astype(np.float32)
    k1, k2 = short_forward.launches, sparsemax_rows.launches
    got = bundle(frames, boxes)
    assert (short_forward.launches - k1, sparsemax_rows.launches - k2) == (2, 1)
    want = live(frames, boxes)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # batch 1: BatchNorm runs cuDNN's kernel in the program as in eager
    one, one_live = bundle(frames[:1], boxes[:1]), live(frames[:1], boxes[:1])
    for k in one_live:
        np.testing.assert_array_equal(one[k], one_live[k], err_msg=k)
    bundle(frames, boxes)  # warm: the first call loads the program
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev = bundle.dispatch(frames, boxes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert dev["keypoints"].is_cuda


@pytest.mark.cuda
def test_portable_bundle_moves_to_the_card(cuda_device, tmp_path):
    """A bundle exported on the CPU for ("cpu", "cuda") (traced with the
    plain versions, attn_impl="einsum") loads on the card and matches the
    same predictor on the CPU; a CPU-only bundle refuses the card."""
    from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
    from probpose_pytorch_tpu_torch.inference import TopDownPredictor
    from probpose_pytorch_tpu_torch.serve.export import ServingBundle, export_predictor_bundle

    cfg = ModelConfig(backbone="vit-nano", attn_impl="einsum", compute_dtype="float32")
    model = build_model(cfg, "cpu", seed=2)
    _peak_heatmap_branch(model)
    codec = Codec(ProbMap((192, 256), (48, 64), sigmas=np.full(17, 0.05, np.float32),
                          sigma=2.0))
    live = TopDownPredictor(model, codec, (256, 192))
    out = export_predictor_bundle(live, tmp_path / "b", buckets=(2,), frame_shape=(320, 256),
                                  platforms=("cpu", "cuda"))
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, size=(2, 320, 256, 3), dtype=np.uint8)
    boxes = rng.uniform([0, 0, 120, 180], [60, 60, 196, 260], (2, 4)).astype(np.float32)
    got = ServingBundle.load(out)(frames, boxes)
    want = live(frames, boxes)
    # keypoints where the OKS-convolved map's top-2 margin exceeds 1e-4
    live.return_heatmaps = True
    maps = torch.from_numpy(live(frames, boxes)["heatmaps"])
    conv = oks_conv(maps, *codec.probmap.conv_operators("cpu")).flatten(2)
    top2 = conv.topk(2, dim=-1).values
    ok = ((top2[..., 0] - top2[..., 1]) > 1e-4).numpy()
    assert ok.mean() > 0.5
    np.testing.assert_allclose(got["keypoints"][ok], want["keypoints"][ok], atol=1e-2)
    for k in ("probabilities", "visibilities", "oks", "errors"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    cpu_only = export_predictor_bundle(live, tmp_path / "c", buckets=(2,), frame_shape=(320, 256))
    with pytest.raises(ValueError, match="not for 'cuda'"):
        ServingBundle.load(cpu_only)
