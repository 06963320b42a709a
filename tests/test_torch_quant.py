"""int8 serving on the CPU: the port's ops/quant.py, models/vit_int8.py and
TopDownPredictor(quantize=...) against the JAX package's.

Same float32 weights (carried across by compat/from_jax.py), same inputs
from np.random.default_rng. The integer codes, scales and int32 products
are held bit for bit. The bf16 trunk and the predictor are held against
JAX's run op by op (`jax.disable_jit()`), where XLA rounds each operation
as PyTorch does: inside JAX's jitted program XLA fuses the bf16 chain and
moves JAX's own int8 features by up to 0.04 against that run, so against
the jitted predictor the bar is a heatmap correlation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.inference import TopDownPredictor as JaxPredictor
from probpose_pytorch_tpu.models import model as jax_model
from probpose_pytorch_tpu.models import vit_int8 as jax_vit_int8
from probpose_pytorch_tpu.ops import quant as jax_quant
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.compat.from_jax import quantized_state_dict_from_jax
from probpose_pytorch_tpu_torch.inference import TopDownPredictor
from probpose_pytorch_tpu_torch.models.model import ModelConfig, build_model
from probpose_pytorch_tpu_torch.models.vit_int8 import QuantizedViT, vit_forward_int8
from probpose_pytorch_tpu_torch.ops import quant

from test_torch_models import TINY_CFG, init_pair
from test_torch_serving import CODEC_KW, _request, _top2_margin, _well_defined

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

# ViT depth 2, width 64, 2 heads (mlp 128: fc2's K = 128)
NANO = dict(TINY_CFG, backbone="vit-nano")
MODES = ("int8", "int8_wo")


def _weights(seed, shape=(64, 48)):
    """(in, out) float32 weights with a zero column, a column whose codes
    fall on .5 (half to even: 2.5 -> 2, -3.5 -> -4) and a wide range."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * rng.uniform(0.01, 3.0, shape[1])).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = 0.0
    w[:4, 1] = [127.0, 2.5, -3.5, 0.5]
    return w


def test_quantize_weight_matches_jax_bit_for_bit():
    w = _weights(0)
    q, s = quant.quantize_weight(torch.from_numpy(w))
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (48,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0] == 1.0 and q[:4, 1].tolist() == [127, 2, -4, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_quantize_rows_matches_jax_bit_for_bit(dtype):
    x = np.random.default_rng(1).normal(size=(3, 7, 64)).astype(np.float32) * 4
    x[0, 0] = 0.0  # a zero row: scale 1, codes 0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    q, s = quant.dynamic_quantize_rows(tx)
    jq, js = jax_quant.dynamic_quantize_rows(jx)
    assert q.shape == (3, 7, 64) and s.shape == (3, 7, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0, 0, 0] == 1.0 and not q[0, 0].any()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(out_dtype):
    """The int32 products are equal; the dequantised result within 1e-5
    relative before the bf16 cast, and within one bf16 rounding after it."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    w = _weights(3, (64, 96))
    bias = rng.normal(size=96).astype(np.float32)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    q, s = quant.quantize_weight(torch.from_numpy(w))
    xq, _ = quant.dynamic_quantize_rows(torch.from_numpy(x).reshape(-1, 64))
    jxq, _ = jax_quant.dynamic_quantize_rows(jnp.asarray(x).reshape(-1, 64))
    acc = torch._int_mm(xq, q)
    jacc = jax.lax.dot_general(jxq, jq, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    out = quant.int8_matmul(torch.from_numpy(x), q, s, torch.from_numpy(bias),
                            getattr(torch, out_dtype))
    ref = jax_quant.int8_matmul(jnp.asarray(x), jq, js, jnp.asarray(bias),
                                getattr(jnp, out_dtype))
    assert out.dtype == getattr(torch, out_dtype) and out.shape == (2, 24, 96)
    ref = np.asarray(ref.astype(jnp.float32))
    rtol = 1e-5 if out_dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=rtol, atol=1e-6)


def test_weight_only_matmul_matches_jax():
    """bf16 activations, weights dequantised in bf16, one bf16 product (K =
    64): equal to JAX's."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(2, 24, 64)), jnp.bfloat16)
    w = _weights(5, (64, 32))
    bias = rng.normal(size=32).astype(np.float32)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    ref = jax_quant.weight_only_matmul(x, jq, js, jnp.asarray(bias))
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
    q, s = quant.quantize_weight(torch.from_numpy(w))
    out = quant.weight_only_matmul(tx, q, s, torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_int8_matmul_shape_rules_on_the_card():
    """torch._int_mm's rules on a CUDA tensor (more than 16 rows, K and N
    multiples of 8) are met by zero padding, as JAX's int8_matmul (a plain
    dot_general) takes any shape: the padded shape, and shapes that meet
    the rules pass unpadded."""
    assert quant.int_mm_padding(16, 64, 64) == (17, 64, 64)
    assert quant.int_mm_padding(192, 60, 64) == (192, 64, 64)
    assert quant.int_mm_padding(192, 64, 100) == (192, 64, 104)
    assert quant.int_mm_padding(1, 12, 5) == (17, 16, 8)
    assert quant.int_mm_padding(17, 64, 64) == (17, 64, 64)
    x = torch.randn(3, 12)
    q, s = quant.quantize_weight(torch.randn(12, 5))
    assert quant.int8_matmul(x, q, s).shape == (3, 5)


@pytest.mark.parametrize("M,K,N", [(1, 12, 5), (16, 60, 100), (5, 64, 64)])
@pytest.mark.parametrize("layout", ["transposed", "row_major"])
def test_padded_int_mm_is_the_plain_product_bit_for_bit(M, K, N, layout):
    """The padded product equals the plain int32 product bit for bit (sums
    with zero terms are exact), for a weight stored (N, K) and passed
    transposed (QuantizedViT's layout) and for a row-major one; and
    int8_matmul on it equals JAX's at the same shape."""
    rng = np.random.default_rng(M * 1000 + K + N)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    b = w.t().contiguous().t() if layout == "transposed" else w
    got = quant.padded_int_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, a.int() @ w.int())
    x = rng.normal(size=(M, K)).astype(np.float32)
    wf = _weights(M + K, (K, N))
    jq, js = jax_quant.quantize_weight(jnp.asarray(wf))
    ref = jax_quant.int8_matmul(jnp.asarray(x), jq, js, out_dtype=jnp.float32)
    q, s = quant.quantize_weight(torch.from_numpy(wf))
    out = quant.int8_matmul(torch.from_numpy(x), q, s, out_dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def nano():
    jm, variables, pm = init_pair(NANO, seed=2)
    qparams = jax_vit_int8.quantize_vit_params(variables["params"]["backbone"], depth=2)
    return jm, variables, pm, qparams


def test_quantize_vit_params_matches_jax_bit_for_bit(nano):
    """The port's quantisation of weights carried from JAX gives JAX's int8
    codes and scales, and the float tensors as they are."""
    state = QuantizedViT(nano[2].backbone).state()
    ours = {k: v.numpy() for k, v in state.items()}
    _, variables, pm, qparams = nano
    head = {"params": variables["params"]["head"],
            "batch_stats": variables["batch_stats"]["head"]}
    theirs = quantized_state_dict_from_jax({"qparams": qparams, "head": head})
    assert sorted(ours) == sorted(k[len("backbone."):] for k in theirs
                                  if k.startswith("backbone."))
    for k, v in ours.items():
        assert v.dtype == theirs["backbone." + k].dtype, k
        np.testing.assert_array_equal(v, theirs["backbone." + k], err_msg=k)
    assert all(state[f"blocks.{i}.{n}.weight_q"].is_contiguous()
               for i in range(2) for n in ("attn_qkv", "attn_proj", "mlp_fc1", "mlp_fc2"))


@pytest.mark.parametrize("mode", MODES)
def test_vit_forward_int8_matches_jax(nano, mode):
    """Features against JAX's vit_forward_int8 run op by op. int8: within
    1e-5 (the products are exact, the float32 steps JAX's). int8_wo: bf16
    products at K = 128 sum in another order than XLA's and move a value
    by one bf16 ulp now and then; within 4 bf16 ulps of the largest
    feature, 4 * 2^-8 * max(1, max|ref|)."""
    _, _, pm, qparams = nano
    x = np.random.default_rng(6).random((3, 64, 48, 3), dtype=np.float32)
    wo = mode == "int8_wo"
    ref = np.asarray(jax_vit_int8.vit_forward_int8(qparams, jnp.asarray(x), patch_size=16,
                                                   depth=2, num_heads=2, weight_only=wo))
    qvit = QuantizedViT(pm.backbone, weight_only=wo)
    with torch.no_grad():
        out = qvit(torch.from_numpy(x))
        again = vit_forward_int8(qvit.state(), torch.from_numpy(x), patch_size=16, depth=2,
                                 num_heads=2, weight_only=wo)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (3, 4, 3, 64)
    assert torch.equal(out, again)
    tol = 1e-5 if not wo else 4 * 2.0**-8 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    # against the float trunk: the quantisation is there and is small
    with torch.no_grad():
        f32 = pm.backbone(torch.from_numpy(x)).numpy()
    assert 0 < np.abs(out.numpy() - f32).max() and np.corrcoef(out.numpy().ravel(),
                                                               f32.ravel())[0, 1] > 0.999


def _pair(mode, **kw):
    """(JAX model, its variables, JAX predictor, port predictor) of the same
    weights and options."""
    jm, variables, pm = init_pair()
    common = dict(input_size=TINY_CFG["img_size"], return_heatmaps=True, quantize=mode, **kw)
    return (jm, variables,
            JaxPredictor(model=jm, variables=variables, codec=JaxCodec(JaxProbMap(**CODEC_KW)),
                         **common),
            TopDownPredictor(model=pm, codec=Codec(ProbMap(**CODEC_KW)), **common))


@pytest.mark.parametrize("mode", MODES)
def test_quantized_predictor_matches_jax(mode):
    """TopDownPredictor(quantize=...) against JAX's on the same weights:
    against its run op by op, keypoints within 1e-3 px where the convolved
    map's top-2 margin exceeds 1e-4 and the other fields within 1e-5;
    against its jitted program, heatmaps correlated above 0.999. The port's
    model holds the quantised trunk as buffers and JAX's head; JAX's
    quantised variables carry into it bit for bit."""
    _, _, jax_pred, port_pred = _pair(mode)
    frames, boxes = _request(3, 6)
    out = port_pred(frames, boxes)
    with jax.disable_jit():
        ref = jax_pred(frames, boxes)
    ok = _top2_margin(ref["heatmaps"]) > 1e-4
    assert ok.mean() > 0.8
    np.testing.assert_allclose(out["keypoints"][ok], ref["keypoints"][ok], rtol=0, atol=1e-3)
    for k in ("heatmaps", "scores", "probabilities", "visibilities", "oks", "errors"):
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
    jitted = jax_pred(frames, boxes)["heatmaps"]
    assert np.corrcoef(out["heatmaps"].ravel(), jitted.ravel())[0, 1] > 0.999
    assert isinstance(port_pred.model.backbone, QuantizedViT)
    sd = quantized_state_dict_from_jax(jax.device_get(jax_pred.variables))
    mine = port_pred.model.state_dict()
    assert sorted(sd) == sorted(mine)
    for k, v in mine.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_quantized_predictor_with_tta_matches_jax():
    """Flip test, multi-scale test and temperatures around the int8 trunk,
    against JAX's predictor run op by op, keypoints where the flip-averaged
    map is well defined at every scale. The float32 LayerNorms differ from
    XLA's by an ulp here and there (XLA sums a row in blocks of 32), and on
    one of these mirrored crops that moves a row's dynamic int8 scale and
    so its codes: a bf16 feature moves by a quantisation step (0.017 in
    block 1's qkv), the heatmaps by 1.0e-3. Keypoints within 2e-2 px, the
    fields within 2e-3."""
    kw = dict(flip_test=True, scale_test=(0.9, 1.0), calibration={"presence": 1.5})
    jm, variables, jax_pred, port_pred = _pair("int8", **kw)
    frames, boxes = _request(8, 3)
    out = port_pred(frames, boxes)
    with jax.disable_jit():
        ref = jax_pred(frames, boxes)
        ok = _well_defined(jm, variables, frames, boxes, (0.9, 1.0), quantize="int8",
                           flip_test=True)
    assert ok.mean() > 0.7
    np.testing.assert_allclose(out["keypoints"][ok], ref["keypoints"][ok], rtol=0, atol=2e-2)
    for k in ("heatmaps", "scores", "probabilities", "visibilities", "oks", "errors"):
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=2e-3, err_msg=k)
    stream = list(port_pred.predict_stream(iter([(frames, boxes)] * 2)))
    for s in stream:
        for k in out:
            np.testing.assert_array_equal(s[k], out[k], err_msg=k)


@pytest.mark.parametrize("over,quantize,mesh", [
    ({}, "int4", None),
    ({}, "int8", object()),
    (dict(num_prefix_tokens=2), "int8", None),
    (dict(adapter_hidden=(24,)), "int8_wo", None),
    (dict(backbone="conv-t"), "int8", None),
])
def test_quantize_refusals_match_jax(over, quantize, mesh):
    """JAX's ValueErrors, word for word: an unknown mode, a mesh, and a
    trunk other than a plain ViT (RADIO's prefix tokens, adapters, a conv
    trunk)."""
    kw = {**TINY_CFG, **over}
    jm = jax_model.build_model(jax_model.ModelConfig(**kw))
    pm = build_model(ModelConfig(**kw), device="cpu")
    with pytest.raises(ValueError) as theirs:
        JaxPredictor(model=jm, variables=None, codec=None, input_size=(64, 48),
                     quantize=quantize, mesh=mesh)
    with pytest.raises(ValueError) as ours:
        TopDownPredictor(model=pm, codec=None, input_size=(64, 48), quantize=quantize,
                         mesh=mesh)
    assert str(ours.value) == str(theirs.value)


def test_quantized_predictor_copy_keeps_its_trunk():
    """dataclasses.replace of a quantised predictor (as the exporter makes
    one) keeps the same int8 trunk rather than quantising it again."""
    import dataclasses

    port_pred = _pair("int8_wo")[3]
    copy = dataclasses.replace(port_pred)
    assert copy.model.backbone is port_pred.model.backbone
    with pytest.raises(ValueError, match="plain ViTBackbones"):
        dataclasses.replace(port_pred, quantize="int8")  # the other mode needs float weights

