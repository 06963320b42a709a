"""The port's ops against the JAX package, on the CPU at small sizes.

Inputs come from numpy generators and cross between the frameworks as numpy
arrays. The `cuda`-marked tests compare each hand-written kernel with its
plain version on the card; they live in test_torch_cuda.py, which imports
no jax so that it runs on the GPU machine.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import numpy_probmaps
from probpose_pytorch_tpu.codec import Codec as JaxCodec
from probpose_pytorch_tpu.codec import ProbMap as JaxProbMap
from probpose_pytorch_tpu.ops import heatmap as jax_heatmap
from probpose_pytorch_tpu.ops import preprocess as jax_pre
from probpose_pytorch_tpu.ops.pallas import packed_attention as jax_packed_attention
from probpose_pytorch_tpu.ops.pallas import sparsemax_pallas
from probpose_pytorch_tpu.ops.sparsemax import sparsemax as jax_sparsemax
from probpose_pytorch_tpu_torch.codec import Codec, ProbMap
from probpose_pytorch_tpu_torch.ops import heatmap, preprocess
from probpose_pytorch_tpu_torch.ops.kernels import plain_versions
from probpose_pytorch_tpu_torch.ops.kernels.attention import (
    packed_attention,
    packed_attention_reference,
)
from probpose_pytorch_tpu_torch.ops.kernels.sparsemax import (
    BLOCK_CANDIDATES,
    WARP_CANDIDATES,
    sparsemax_candidates_reference,
    sparsemax_reference,
    sparsemax_route,
    sparsemax_rows,
)
from probpose_pytorch_tpu_torch.ops.sparsemax import sparsemax

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "probpose_pytorch_tpu_torch"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# --------------------------------------------------------------------------
# package rules


def _banned_imports(path: pathlib.Path) -> list[str]:
    """Modules imported by `path` that the port must never import."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "probpose_pytorch_tpu"):
                bad.append(f"{path.relative_to(REPO)}: {name}")
    return bad


def test_port_imports_no_jax():
    """Static check: a sys.modules check proves nothing here, since the
    environment may import jax at interpreter start."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [b for f in files for b in _banned_imports(f)]
    assert not bad, bad


# The JAX names of the eight __init__ namespaces the port leaves out, and why.
EXPORT_EXCLUSIONS = {
    # renamed: the port's take and return PyTorch state dicts
    ("models", "merge_lora_params"): "models.lora.merge_lora_state_dict",
    ("compat", "import_head_params"): "compat.torch_import.import_head_state_dict",
    ("compat", "import_timm_vit_params"): "compat.torch_import.import_timm_vit_state_dict",
    # flax: init from an rng and a sample input; the port's
    # TrainState(model, tx, ema) takes a built module
    ("train", "create_train_state"): "train.state.TrainState",
}


def _jax_init_names(sub: str) -> list[str]:
    """The names a JAX package __init__ binds: its imports and assignments."""
    path = REPO / "probpose_pytorch_tpu" / sub / "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets]
    return names


@pytest.mark.parametrize("sub", ["", "models", "train", "data", "ops", "compat", "utils",
                                 "parallel"])
def test_port_exports_the_jax_names(sub):
    """Every name of the JAX package's __init__ files is bound in the port's
    counterpart, or is on EXPORT_EXCLUSIONS with the reason; the int8
    primitives ride with ops."""
    import importlib

    port = importlib.import_module("probpose_pytorch_tpu_torch" + (f".{sub}" if sub else ""))
    names = _jax_init_names(sub)
    assert names
    missing = [n for n in names if not hasattr(port, n)
               and (sub or "pkg", n) not in EXPORT_EXCLUSIONS]
    assert not missing, missing
    stale = [n for (s, n) in EXPORT_EXCLUSIONS if s == sub and hasattr(port, n)]
    assert not stale, stale
    for n in getattr(port, "__all__", []):
        assert hasattr(port, n), n
    if sub == "ops":
        assert {"quantize_weight", "dynamic_quantize_rows", "int8_matmul",
                "weight_only_matmul"} <= set(port.__all__)
    if sub == "":
        assert port.__version__ == "0.1.0"


# --------------------------------------------------------------------------
# preprocess


def test_crop_resize_matches_jax():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(3, 40, 32, 3), dtype=np.uint8)
    boxes = rng.uniform([-4, -4, 10, 15], [10, 12, 30, 40], (3, 4)).astype(np.float32)
    ref = np.asarray(jax_pre.crop_resize(jnp.asarray(frames), jnp.asarray(boxes),
                                         (32, 24), "bilinear_matmul"))
    out = preprocess.crop_resize(_t(frames), _t(boxes), (32, 24), "bilinear_matmul").numpy()
    assert out.shape == ref.shape == (3, 32, 24, 3)
    # Both sides round weights, image and the row product to bf16 and sum in
    # f32; a different f32 summation order can move the intermediate across
    # one bf16 rounding boundary, i.e. by one bf16 ulp of a value <= 1.
    np.testing.assert_allclose(out, ref, rtol=0, atol=2.0**-8)
    assert np.mean(np.abs(out - ref)) < 1e-5


def test_crop_resize_rejects_other_methods():
    """A method outside JAX's `Method` raises ValueError, as
    jax.image.scale_and_translate does for an unknown method."""
    for method in ("nearest", "bicubic_gather"):
        with pytest.raises(ValueError, match=f"unknown crop_resize method '{method}'"):
            preprocess.crop_resize(torch.zeros(1, 8, 8, 3), torch.ones(1, 4), (4, 4), method)
        with pytest.raises(ValueError):
            jax_pre.crop_resize(jnp.zeros((1, 8, 8, 3)), jnp.ones((1, 4)), (4, 4), method)


def test_keypoint_maps_match_jax_and_invert():
    rng = np.random.default_rng(1)
    kpts = rng.uniform(0, 50, (4, 5, 2)).astype(np.float32)
    boxes = rng.uniform([0, 0, 20, 30], [10, 10, 40, 60], (4, 4)).astype(np.float32)
    fwd = preprocess.transform_keypoints(_t(kpts), _t(boxes), (64, 48))
    ref = jax_pre.transform_keypoints(jnp.asarray(kpts), jnp.asarray(boxes), (64, 48))
    np.testing.assert_allclose(fwd.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)  # f32 rounding
    back = preprocess.untransform_keypoints(fwd, _t(boxes), (64, 48))
    ref_back = jax_pre.untransform_keypoints(ref, jnp.asarray(boxes), (64, 48))
    np.testing.assert_allclose(back.numpy(), np.asarray(ref_back), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), kpts, atol=1e-4)  # round trip in f32


# --------------------------------------------------------------------------
# decode


def _maps(seed, B=5, K=4, H=64, W=48):
    rng = np.random.default_rng(seed)
    kpts = rng.uniform([3, 3], [W - 4, H - 4], (B, K, 2)).astype(np.float32)
    sigmas = rng.uniform(0.03, 0.12, (K,)).astype(np.float32)
    maps, _ = numpy_probmaps((W, H), kpts, np.ones((B, K)), sigmas, -1.0)
    noise = 0.03 * rng.random((B, K, H, W), dtype=np.float32)
    return np.clip(maps + noise, 0, 1).astype(np.float32), sigmas


def test_oks_operators_are_the_jax_operators():
    _, sigmas = _maps(0)
    ours = heatmap.build_oks_conv_operators(sigmas, 64, 48)
    ref = jax_heatmap.build_oks_conv_operators(sigmas, 64, 48)
    np.testing.assert_array_equal(ours.row_op, ref.row_op)
    np.testing.assert_array_equal(ours.col_op, ref.col_op)


def test_expected_value_decode_matches_jax():
    maps, sigmas = _maps(0)
    ops = jax_heatmap.build_oks_conv_operators(sigmas, 64, 48)
    locs_ref, vals_ref, conv_ref = jax_heatmap.expected_value_decode(
        jnp.asarray(maps), ops, return_heatmap=True)
    locs, vals, conv = heatmap.expected_value_decode(
        _t(maps), _t(ops.row_op), _t(ops.col_op), return_heatmap=True)
    # f32 products in another summation order than XLA's HIGHEST.
    np.testing.assert_allclose(conv.numpy(), np.asarray(conv_ref), rtol=1e-5, atol=1e-6)
    # The repo's decode bar: 1e-3 px (docs/PERF.md "Decode parity").
    np.testing.assert_allclose(locs.numpy(), np.asarray(locs_ref), atol=1e-3)
    # Raw values read at the same integer argmax: identical.
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_ref))


def test_heatmap_maximum_and_refine_match_jax():
    maps, _ = _maps(2, B=3, K=3, H=16, W=12)
    maps[0, 0] = 0.0  # empty map -> -1 locations
    maps[1, 1, 3, 4] = maps[1, 1, 7, 2] = 5.0  # tie -> first occurrence
    locs, vals = heatmap.heatmap_maximum(_t(maps))
    locs_ref, vals_ref = jax_heatmap.heatmap_maximum(jnp.asarray(maps))
    np.testing.assert_array_equal(locs.numpy(), np.asarray(locs_ref))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_ref))
    assert locs[1, 1].tolist() == [4.0, 3.0]
    ref = jax_heatmap.subpixel_refine(jnp.asarray(maps), locs_ref)
    out = heatmap.subpixel_refine(_t(maps), locs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)  # same f32 ops


def test_codec_decode_matches_jax():
    maps, _ = _maps(3, K=17)
    rng = np.random.default_rng(3)
    scalars = [rng.random((5, 17, 1, 1)).astype(np.float32) for _ in range(4)]
    kw = dict(input_size=(192, 256), heatmap_size=(48, 64),
              sigmas=np.full(17, 0.05, np.float32), sigma=2.0)
    ref = JaxCodec(JaxProbMap(**kw)).decode(
        tuple(jnp.asarray(a) for a in (maps, *scalars)))
    out = Codec(ProbMap(**kw)).decode(tuple(_t(a) for a in (maps, *scalars)))
    (k_ref, s_ref), *rest_ref = ref
    (k, s), *rest = out
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), atol=1e-3)  # decode bar, px
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    for a, b in zip(rest, rest_ref):
        assert a.shape == b.shape == (5, 1, 17)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)  # one f32 division


def test_probmap_decode_single_instance_matches_jax():
    maps, _ = _maps(4, B=1, K=17)
    kw = dict(input_size=(192, 256), heatmap_size=(48, 64),
              sigmas=np.full(17, 0.079, np.float32))
    k_ref, v_ref = JaxProbMap(**kw).decode(jnp.asarray(maps[0]))
    k, v = ProbMap(**kw).decode(_t(maps[0]))
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), atol=1e-3)  # decode bar, px
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))


# --------------------------------------------------------------------------
# sparsemax (K2's plain version and the autograd wrapper)


def test_sparsemax_plain_matches_pallas_and_xla():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(4, 17, 256)).astype(np.float32) * 2
    pallas = np.asarray(sparsemax_pallas(jnp.asarray(z), interpret=True))
    xla = np.asarray(jax_sparsemax(jnp.asarray(z)))
    ours = sparsemax(_t(z)).numpy()
    # Exact tau from the same support; f32 sums in another order.
    np.testing.assert_allclose(ours, pallas, atol=1e-6)
    np.testing.assert_allclose(ours, xla, atol=1e-6)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)  # on the simplex


def test_sparsemax_rows_cpu_is_plain_and_ragged():
    rng = np.random.default_rng(5)
    z = rng.normal(size=(17 * 3 + 5, 300)).astype(np.float32) / 0.5
    out = sparsemax_rows(_t(z))
    np.testing.assert_array_equal(out.numpy(), sparsemax_reference(_t(z)).numpy())
    ref = np.asarray(jax_sparsemax(jnp.asarray(z)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)  # as above


def test_sparsemax_grad_matches_jax():
    rng = np.random.default_rng(1)
    z = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    t = rng.normal(size=z.shape).astype(np.float32)
    g_ref = jax.grad(lambda x: jnp.sum(jax_sparsemax(x) * t))(jnp.asarray(z))
    zt = _t(z).requires_grad_(True)
    (sparsemax(zt) * _t(t)).sum().backward()
    # Closed form on the same support; one f32 mean per row.
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(g_ref), atol=1e-6)


def _k2_rows(case: str) -> np.ndarray:
    """Rows for K2's candidate twin: random rows of the flagship's and the
    768 x 768 path's lengths, and the adversarial ones."""
    rng = np.random.default_rng(6)
    if case == "flagship":
        return (rng.normal(size=(56, 3072)) / 0.5).astype(np.float32)
    if case == "768":
        return (rng.normal(size=(3, 36864)) / 0.5).astype(np.float32)
    if case == "all candidates":  # every element within 1 of the max
        return rng.random((4, 2000), dtype=np.float32)
    if case == "ties":
        z = (rng.normal(size=(4, 3072)) / 0.5).astype(np.float32)
        z[:, ::500] = z.max(axis=-1, keepdims=True)
        return z
    if case == "N = 1":
        return rng.normal(size=(5, 1)).astype(np.float32)
    z = 4.0 * rng.random((4, 1000), dtype=np.float32)  # "at lo0"
    z[:, 0], z[:, 1::97] = 5.0, 4.0  # lo0 = 4.0 exactly: no candidates
    return z


@pytest.mark.parametrize("case", ["flagship", "768", "all candidates", "ties", "N = 1",
                                  "at lo0"])
def test_sparsemax_candidates_twin_matches_plain_and_pallas(case):
    """K2's design (bisection over the candidates z > fl(max - 1), compacted
    in row order; the whole row where they overflow the buffer) against the
    plain version and the Pallas kernel: exact tau from the same support,
    f32 sums in another order, so 1e-6; rows on the simplex within 1e-5."""
    z = _k2_rows(case)
    ref = sparsemax_reference(_t(z)).numpy()
    pallas = np.asarray(sparsemax_pallas(jnp.asarray(z), interpret=True))
    capacities = (WARP_CANDIDATES, BLOCK_CANDIDATES, 2)  # 2: the whole-row fallback
    for capacity in capacities:
        twin = sparsemax_candidates_reference(_t(z), capacity).numpy()
        np.testing.assert_allclose(twin, ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(twin, pallas, rtol=0, atol=1e-6)
        np.testing.assert_allclose(twin.sum(-1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("N,route", [(1, ("warp", 8)), (256, ("warp", 8)), (257, ("warp", 32)),
                                     (3072, ("warp", 96)), (3073, ("block staged", 0)),
                                     (36864, ("block staged", 0)), (53952, ("block staged", 0)),
                                     (53953, ("block", 0)), (65536, ("block", 0))])
def test_sparsemax_route(N, route):
    """One warp a row up to 3,072 pixels; one block a row beyond, staged in
    shared memory while the row and the candidate buffer fit an H100's
    232,448 bytes."""
    assert sparsemax_route(N, 232448) == route


def test_sparsemax_rows_checks_inputs():
    with pytest.raises(TypeError):
        sparsemax_rows(torch.zeros(2, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        sparsemax_rows(torch.zeros(2, 3, 8))
    with pytest.raises(ValueError):
        sparsemax_rows(torch.zeros(8, 2).t())


# --------------------------------------------------------------------------
# packed attention (K1's plain version)


@pytest.mark.parametrize("shape,heads", [((4, 32, 3 * 48), 3), ((5, 8, 3 * 16), 2)])
def test_packed_attention_plain_matches_pallas(shape, heads):
    rng = np.random.default_rng(0)
    qkv = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(jax_packed_attention(jnp.asarray(qkv), heads, group=2, interpret=True))
    out = packed_attention(_t(qkv), heads).numpy()
    # f32 scores and softmax on both sides; summation order differs.
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out, packed_attention_reference(_t(qkv), heads).numpy())


def test_packed_attention_bf16_rounds_p_like_jax():
    rng = np.random.default_rng(3)
    qkv = rng.normal(size=(2, 16, 3 * 32)).astype(np.float32)
    qb = jnp.asarray(qkv, jnp.bfloat16)
    from probpose_pytorch_tpu.ops.pallas.attention_kernel import _einsum_packed_attention

    ref = np.asarray(_einsum_packed_attention(qb, 2).astype(jnp.float32))
    out = packed_attention(_t(qkv).to(torch.bfloat16), 2).float().numpy()
    # Same bf16 inputs and bf16-rounded P; the outputs may land one bf16
    # ulp apart (values here are below 4, so 2^-6 bounds one ulp).
    np.testing.assert_allclose(out, ref, rtol=0, atol=2.0**-6)


def test_packed_attention_checks_inputs():
    with pytest.raises(ValueError, match="3 \\* heads"):
        packed_attention(torch.zeros(1, 4, 3 * 10), 3)
    with pytest.raises(TypeError):
        packed_attention(torch.zeros(1, 4, 12, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="contiguous"):
        packed_attention(torch.zeros(1, 12, 4).transpose(1, 2), 2)


def test_plain_switch_restores():
    from probpose_pytorch_tpu_torch.ops.kernels import plain_enabled

    assert not plain_enabled()
    with plain_versions():
        assert plain_enabled()
    assert not plain_enabled()
