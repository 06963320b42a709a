// Multi-head attention in bf16 for Hopper (sm_90a), read straight from the
// packed qkv with TMA and multiplied with wgmma: kernel K4 (row-tiled, long
// sequences, forward and backward) and K1's bf16 forward for N <= 256 (the
// ViT trunks' short sequences). K4's backward serves K1's bf16 shapes too.
//
// Replaces the TPU kernels `_tiled_fwd_kernel` and `_tiled_bwd_kernel`
// (probpose_pytorch_tpu/ops/pallas/attention_tiled.py:119-192), which the JAX
// package's `packed_attention` takes wherever the packed kernel's (N, N)
// scores do not fit (a ViT trunk on 768 x 768 inputs, N = 2304), and, in
// bf16 with d a multiple of 8 in [16, 256], `_packed_fwd_kernel` and
// `_packed_bwd_kernel` (attention_kernel.py:120-191). The float32 path, and
// bf16 at the other widths, stay on the CUDA cores in csrc/tiled_attention.cu
// and csrc/packed_attention.cu.
//
// Short-sequence forward (N <= 256, e.g. N = 192, d = 64): ~100 FLOP per
// byte, under the ~295 FLOP/byte ridge, so it is bound by reading qkv and
// writing the context, not by the products. A block is one warpgroup that
// owns 64 query rows of one (b, h) (N = 192 fills three blocks with no
// padded row); one TMA barrier brings its Q rows and the head's whole K and
// V (56 KB at N = 192, d = 64), so three blocks share an SM and one block's
// loads overlap another's math; the blocks of one head run side by side and
// share its K and V through L2. S = Q K^T by wgmma m64n64k16 over the keys
// padded to a multiple of 64 stays in registers, so the softmax is exact in
// one pass; P is normalised and rounded to bf16 before P.V, the TPU kernel's
// order, and fed as wgmma's register A operand.
//
// What it computes, per (batch b, head h), with q, k, v the column slices of
// the qkv-major (B, N, 3C) projection and the context written h-major into
// (B, N, C): ctx = softmax_f32(q k^T * scale) v, the softmax exact in f32, P
// rounded to bf16 before P.V, f32 sums. The backward gives dqkv (B, N, 3C)
// with dS = round(P * (dP - D) * scale), dQ = dS K, dK = dS^T Q and
// dV = round(P)^T dO, f32 sums.
//
// What bounds it on an H100: at (64, 2304, 1152) the forward does two
// products of 2 N^2 d FLOP per (b, h) against ~0.45 GB of qkv in and context
// out, ~1,100 FLOP per byte, far above the ~295 FLOP/byte ridge: it is bound
// by operations, and only wgmma reaches the card's bf16 rate. So:
//
// Forward, one sweep over the keys (online softmax). A block owns 128 query
// rows of one (b, h): two consumer warpgroups of 64 rows and one producer
// warpgroup whose single thread keeps a ring of K/V tiles of 128 keys in
// flight with TMA (a 4-D tensor map over the (B, N, 3C) qkv's head slots,
// below; rows past N arrive as zeros). Per tile: S = Q K^T by wgmma m64n128k16 from shared memory into
// registers; the row max and sum over the accumulator's quads; P =
// exp2(S * scale * log2 e - m), rounded to bf16 in registers and fed as
// wgmma's register A operand against V (read MN-major); O is rescaled in
// registers when the max grows and divided by l once at the end. It also
// writes, when asked, the row log-sum-exp lse = m * scale + log l, which the
// backward uses instead of a statistics sweep. This rounds exp(s - m_running)
// rather than the TPU's normalised P; the difference stays within the K1/K4
// bound (plain twin: tiled_attention_online_reference).
//
// Backward, two kernels, seven products (nine with the TPU's D below), no
// atomics (two runs give the same bits):
//   dQ kernel (128 query rows a block, K and V streamed in tiles of 64 keys):
//     D for its rows, kept in a (B, H, N) f32 buffer; per tile S = Q K^T,
//     dP = dO V^T, P = exp(S * scale - lse), dS = round(P * (dP - D) *
//     scale) in registers, dQ += dS K. D is rowsum(dP * P) over the
//     unrounded P, the TPU's order, from a first sweep over the key tiles
//     (S and dP only) at N <= 256 (`exact_d`), and rowsum(dO * O) past that.
//   dK/dV kernel (128 keys a block, Q, dO and their lse / D streamed in tiles
//     of 64 rows): S^T = K Q^T, dP^T = V dO^T, dV += round(P^T) dO,
//     dK += dS^T Q; dK and dV stay in f32 registers and are written once.
// D from dO * O is the FlashAttention identity; the TPU sums dP * P over the
// unrounded P, so the two differ by the bf16 rounding of O. That is within
// the bound at N = 2304, but at N = 192 it moved K1's backward 2 bf16 ulps
// from the TPU-order plain version on one of eight draws, so short
// sequences pay the second sweep (two products a tile) for the TPU's D.
//
// Head widths: every multiple of 8 from 16 to 256. The kernels are
// templated on the padded width Dp = 16 ceil(d / 16) (sixteen widths, all
// instantiated, in csrc/tiled_attention_sm90.cuh) with d a run-time value;
// d in {32, 64, 80, 128} runs the kernels it ran before at Dp = d, with the
// same bits. Shared-memory tiles carry TMA's 128-byte swizzle where 64
// divides Dp (Dp = 128: two 64-column boxes), the 64-byte one at Dp = 32
// and the 32-byte one, 16-column boxes, at every other Dp (d = 80: five):
// a wgmma descriptor names one swizzle, so every product keeps one
// descriptor per operand (QK^T's k = Dp is Dp / 16 k16 steps; P.V is one
// m64nDpk16 whose B operand walks the boxes by its leading offset). The
// register-A products of every width come from one asm template
// (csrc/sm90.cuh, WgmmaRs).
//
// d = 8 (mod 16) (24, 40, ..., 88 for ViT-g's 16 heads, ..., 248): the last
// 16-column box of a head would hold 8 columns of the next slot (the next
// head, or the same head's next part head-major). The tensor maps are 4-D,
// (column < d, slot, row, batch), so those 8 columns lie past the map's
// first extent and TMA writes zeros there: the products that contract over
// d (S = QK^T, dP = dO V^T, and their transposes) add exact zeros, in the
// order of a d-exact product, and nothing of the neighbour is read, even a
// NaN. Products that yield d columns (O, dQ, dK, dV) store exactly d of
// them, so no block writes into a neighbour another block owns.
//
// Past Dp = 128 (d > 128) registers and shared memory change the tiles:
// the forward's key tiles are 64 keys (S beside an O of Dp / 2 registers a
// thread), and the consumer warpgroups take 240 registers, the producer 24;
// the dK/dV kernel owns 64 keys a block, warpgroup 0 their dV and 1 their
// dK (both would be Dp registers a thread), each recomputing S^T; the dQ
// kernel's K/V ring drops to one stage past Dp = 224 (two would need 245 KB
// at Dp = 240). The short forward holds a head's whole K and V: its shared
// memory is 1 KB + 128 Dp + 256 Dp ceil(N / 64) bytes, which passes the
// card's 227 KB only at N > 192 with Dp >= 208; the route
// (ops/kernels/attention_tiled.py) asks `short_attention_sm90_smem_bytes`
// and sends those shapes to the tiled forward. The scale is 1 / sqrt(d).
//
// Plain-C interface, loaded with ctypes (ops/kernels/attention_tiled.py).
// Every entry point returns a cudaError_t as int (0 = success).

#include "tiled_attention_sm90.cuh"

namespace probpose_sm90 {

// The launchers are instantiated in tiled_attention_sm90_w*.cu.
PROBPOSE_SM90_WIDTHS(PROBPOSE_SM90_EXTERN)

namespace {

// Whether the kernels take head width d, and its padded width.
bool takes(int d) { return d >= 16 && d <= 256 && d % 8 == 0; }
int padded(int d) { return (d + 15) / 16 * 16; }

}  // namespace
}  // namespace probpose_sm90

using namespace probpose_sm90;

// Shared memory of the forward (pass 0), the dQ kernel (1) or the dK/dV
// kernel (2) at head width d; -1 for a d it does not take.
extern "C" long long tiled_attention_sm90_smem_bytes(int d, int pass) {
  if (!takes(d)) return -1;
#define PROBPOSE_SMEM(Dp) \
  case Dp: return pass == 0 ? Fwd<Dp>::kSmem : pass == 1 ? Dq<Dp>::kSmem : Dkv<Dp>::kSmem;
  switch (padded(d)) {
    PROBPOSE_SM90_WIDTHS(PROBPOSE_SMEM)
    default: return -1;
  }
#undef PROBPOSE_SMEM
}

// Shared memory of the short-sequence forward at head width d and N keys
// (1 <= N <= 256); -1 for a shape it does not take. Past the card's limit
// it has no kernel (launch_short_nt).
extern "C" long long short_attention_sm90_smem_bytes(int d, int N) {
  if (N < 1 || N > 256 || !takes(d)) return -1;
  const int nt = (N + 63) / 64;
#define PROBPOSE_SMEM(Dp) case Dp: return Short<Dp, 1>::kSmem + (nt - 1) * 2 * Tile<Dp>::bytes(64);
  switch (padded(d)) {
    PROBPOSE_SM90_WIDTHS(PROBPOSE_SMEM)
    default: return -1;
  }
#undef PROBPOSE_SMEM
}

namespace {

int short_any(const ShortArgs& a, void* out, float* lse, int B, int N, int C, int H,
              cudaStream_t stream) {
  if (N < 1 || N > 256 || !takes(a.d)) return cudaErrorInvalidValue;
#define PROBPOSE_SHORT(Dp) case Dp: return launch_short<Dp>(a, out, lse, B, N, C, H, stream);
  switch (padded(a.d)) {
    PROBPOSE_SM90_WIDTHS(PROBPOSE_SHORT)
    default: return cudaErrorInvalidValue;
  }
#undef PROBPOSE_SHORT
}

}  // namespace

// Short-sequence forward, 1 <= N <= 256: bf16 qkv (B, N, 3C) qkv-major, or
// head-major with head_major (column of (t, h, c): t * d + h * 3d + c), in ->
// context (B, N, C) out and, unless lse is null, the row log-sum-exp
// (B, heads, N) f32.
extern "C" int short_attention_sm90_fwd(const void* qkv, void* out, void* lse, int B, int N,
                                        int C, int heads, int head_major, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long row = 3LL * C;
  const int d = C / heads, ts = head_major ? 1 : heads;
  const ShortArgs a{qkv, qkv, qkv, 0, ts, 2 * ts, 3 * heads, head_major ? 3 : 1, d,
                    row * N, row};
  return short_any(a, out, static_cast<float*>(lse), B, N, C, heads,
                   static_cast<cudaStream_t>(stream));
}

// Kernel K6 on the same kernel, 1 <= N <= 256: q, k and v (B, N, heads, d)
// bf16 views sharing the element strides (batch, row), head stride d and unit
// stride along d (e.g. the q, k, v views of one packed projection) in ->
// context (B, N, heads, d) out.
extern "C" int flat_short_attention_sm90_fwd(const void* q, const void* k, const void* v,
                                             void* out, int B, int N, int heads, int d,
                                             long long batch_stride, long long row_stride,
                                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ShortArgs a{q, k, v, 0, 0, 0, heads, 1, d, batch_stride, row_stride};
  return short_any(a, out, nullptr, B, N, heads * d, heads, static_cast<cudaStream_t>(stream));
}

// bf16 qkv (B, N, 3C) qkv-major, or head-major with head_major, in ->
// context (B, N, C) out and, unless lse is null, the row log-sum-exp
// (B, heads, N) f32.
extern "C" int tiled_attention_sm90_fwd(const void* qkv, void* out, void* lse, int B, int N,
                                        int C, int heads, int head_major, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!takes(C / heads)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define PROBPOSE_FWD(Dp) \
  case Dp: return launch_fwd<Dp>(qkv, out, l, B, N, C, heads, head_major, s);
  switch (padded(C / heads)) {
    PROBPOSE_SM90_WIDTHS(PROBPOSE_FWD)
    default: return cudaErrorInvalidValue;
  }
#undef PROBPOSE_FWD
}

// bf16 qkv (B, N, 3C) (head-major with head_major), the forward's context out
// and its lse, and dout (B, N, C) in -> dqkv (B, N, 3C) out, in qkv's layout;
// dsum is (B, heads, N) f32 scratch
// for D: rowsum(dP * P) over the unrounded P (the TPU's order) when exact_d,
// else rowsum(dout * out), which reads out instead of sweeping the keys twice.
extern "C" int tiled_attention_sm90_bwd(const void* qkv, const void* out, const void* dout,
                                        const void* lse, void* dsum, void* dqkv, int B, int N,
                                        int C, int heads, int head_major, int exact_d,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!takes(C / heads)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
#define PROBPOSE_BWD(Dp)                                                                  \
  case Dp:                                                                                \
    return launch_bwd<Dp>(qkv, out, dout, l, ds, dqkv, B, N, C, heads, head_major, exact_d, \
                          s);
  switch (padded(C / heads)) {
    PROBPOSE_SM90_WIDTHS(PROBPOSE_BWD)
    default: return cudaErrorInvalidValue;
  }
#undef PROBPOSE_BWD
}
