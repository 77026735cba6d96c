// K11: GroupNorm -> swish -> 3x3 conv (stride 1, zero pad 1), NHWC / HWIO,
// for Hopper, sm_90a.
//
// Replaces text_to_sound_synthesis_tpu/ops/fused_gn_conv.py::gn_swish_conv
// (its Pallas TPU kernel _conv_call / _kernel). The plain PyTorch twin is
// text_to_sound_synthesis_torch/ops/fused_gn_conv.py::gn_swish_conv_reference;
// the wrapper there (a torch.autograd.Function whose backward is the twin's
// VJP, as the TPU kernel's custom VJP is the XLA composition's) launches this.
//
// What it computes, in the twin's order: per (batch, group) the mean and
// mean square of x in f32, var = E[x^2] - E[x]^2 (fast variance), rstd =
// 1 / sqrt(var + 1e-6); scale = rstd * gamma, shift = beta - mean * scale per
// (batch, channel); a = x * scale + shift, a = a * sigmoid(a) in f32, rounded
// to bf16; y = conv3x3(a zero-padded, w bf16) summed in f32, + bias, one cast
// to bf16. Taps outside the image contribute 0 (the pad of the activated
// tensor), not swish(shift).
//
// What bounds it on an H100. At the largest decoder stage, (8, 80, 848, 128),
// the products are 1.6e11 bf16 FLOP = 162 us at 989 TFLOP/s, against 278 MB
// of bytes (x read, y written) = 83 us at 3.35 TB/s: operation-bound at every
// stage. So the design keeps the tensor cores fed and moves no extra bytes:
//   - the statistics: one launch reads x once and writes per-(block, batch,
//     group) partial sums of x and x^2 (no float atomics, so the result does
//     not change from run to run); a tiny launch sums them in a fixed order,
//     a warp per group, and writes scale and shift per (batch, channel);
//   - the conv is an implicit GEMM, M = B*H*W pixels, N = Co, K = 9*C: a
//     block owns a strip of 64 pixels of one output row and 128 output
//     channels (8 warps of 32 x 32); it walks C in chunks of 32 channels, and
//     for each chunk copies the three input rows of its strip plus the halo
//     columns (3 x 66 pixels) into shared memory with cp.async, then each
//     thread normalises, swishes and rounds to bf16 in place the pieces it
//     copied: the activated tensor never reaches HBM;
//   - each of the chunk's 9 taps is one k step: the A fragments are the halo
//     tile shifted by (dy, dx), the 128 x 32 weight tile of that tap streams
//     through a two-stage cp.async ring (the next chunk's halo loads during
//     this chunk's taps); mma.sync m16n8k16 bf16 products, f32 sums;
//   - the weight is (Co, 9, C) bf16, K-contiguous, made by the wrapper from
//     HWIO (the TPU kernel casts it to x.dtype on every call too).
// mma.sync reaches a fraction of the card's bf16 rate (wgmma with TMA-fed
// rings is the way to the rest), and ragged rows waste up to 17 % of a strip
// (W = 53, 106, 212); making it fast is later work.
// Limits (checked here and by the wrapper): C a multiple of 32 and at most
// 2048, Co a multiple of 128, groups dividing C, H and B at most 65535.
// Every multiply and add that the twin does as a separate tensor op is an _rn
// intrinsic (no FMA contraction). No --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

using t2s_int8::cp_async16;
using t2s_int8::cp_async_commit;
using t2s_int8::cp_async_wait;
using t2s_int8::mma_bf16;

constexpr int kThreads = 256;
constexpr int kStatPix = 256;          // pixels of one image per statistics block
constexpr int kMaxC = 2048;            // the statistics block holds 8 channels a thread
constexpr int TW = 64;                 // output pixels per conv block (one row strip)
constexpr int BN = 128;                // output channels per conv block
constexpr int CK = 32;                 // input channels per chunk: one 64-byte k slice
constexpr int kRow = CK * 2 + 16;      // shared-memory row of 32 bf16, padded (80 bytes)
constexpr int kHaloCols = TW + 2;
constexpr int kHaloPieces = 3 * kHaloCols * (CK / 8);   // 16-byte pieces of a halo tile
constexpr int kHaloBytes = 3 * kHaloCols * kRow;
constexpr int kWBytes = BN * kRow;
constexpr int kSmem = 2 * kHaloBytes + 2 * kWBytes;
constexpr float kEps = 1e-6f;

// partial[((b * nchunk + chunk) * 2 + m) * G + g]: m 0 the sum of x, 1 of x^2
// over the block's pixels and the group's channels.
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                                            int HW, int C, int G,
                                                            float* __restrict__ partial) {
  __shared__ float red[2][kThreads * 8];   // [moment][lane * C + channel]
  const int b = blockIdx.y, chunk = blockIdx.x, nchunk = gridDim.x;
  const int tpp = C / 8, lanes = kThreads / tpp;   // threads per pixel, pixel lanes
  const int t = threadIdx.x, cv = t % tpp, lane = t / tpp;
  const int p1 = min((chunk + 1) * kStatPix, HW);
  if (lane < lanes) {
    float s[8], q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.0f;
    const __nv_bfloat16* xb = x + static_cast<size_t>(b) * HW * C + cv * 8;
    for (int p = chunk * kStatPix + lane; p < p1; p += lanes) {
      const uint4 v = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(p) * C);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        s[2 * e] += f.x;
        s[2 * e + 1] += f.y;
        q[2 * e] += f.x * f.x;
        q[2 * e + 1] += f.y * f.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[0][lane * C + cv * 8 + e] = s[e];
      red[1][lane * C + cv * 8 + e] = q[e];
    }
  }
  __syncthreads();
  const int gs = C / G;
  for (int i = t; i < 2 * G; i += kThreads) {
    const int m = i / G, g = i % G;
    float acc = 0.0f;
    for (int c = g * gs; c < (g + 1) * gs; ++c)
      for (int l = 0; l < lanes; ++l) acc += red[m][l * C + c];
    partial[(static_cast<size_t>(b) * nchunk + chunk) * 2 * G + i] = acc;
  }
}

// One block per image, a warp per group: the group statistics from the
// partial sums (lane l takes chunks l, l + 32, ..., then a fixed butterfly:
// the same order on every run), then scale / shift per channel, as the twin's
// gn_affine.
__global__ void __launch_bounds__(kThreads) gn_finalize_kernel(
    const float* __restrict__ partial, int nchunk, int C, int G, float n,
    const float* __restrict__ gamma, const float* __restrict__ beta, float* __restrict__ scale,
    float* __restrict__ shift) {
  __shared__ float mean_s[kMaxC], rstd_s[kMaxC];
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < G; g += kThreads / 32) {
    float s = 0.0f, q = 0.0f;
    for (int k = lane; k < nchunk; k += 32) {
      const float* p = partial + (static_cast<size_t>(b) * nchunk + k) * 2 * G;
      s += p[g];
      q += p[G + g];
    }
    s = t2s_int8::warp_sum(s);
    q = t2s_int8::warp_sum(q);
    if (lane != 0) continue;
    const float mean = __fdiv_rn(s, n);
    const float var = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(mean, mean));
    mean_s[g] = mean;
    rstd_s[g] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, kEps)));
  }
  __syncthreads();
  const int gs = C / G;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float sc = __fmul_rn(rstd_s[c / gs], gamma[c]);
    scale[static_cast<size_t>(b) * C + c] = sc;
    shift[static_cast<size_t>(b) * C + c] = __fsub_rn(beta[c], __fmul_rn(mean_s[c / gs], sc));
  }
}

// a = x * scale + shift, a * sigmoid(a) = a * (1 / (1 + exp(-a))), in f32
__device__ __forceinline__ float gn_swish(float x, float sc, float sh) {
  const float a = __fadd_rn(__fmul_rn(x, sc), sh);
  return __fmul_rn(a, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a))));
}

struct ConvArgs {
  const __nv_bfloat16* x;   // (B, H, W, C)
  const __nv_bfloat16* w;   // (Co, 9, C), tap = 3 * dy + dx
  const float* scale;       // (B, C)
  const float* shift;       // (B, C)
  const float* bias;        // (Co,)
  __nv_bfloat16* y;         // (B, H, W, Co)
  int H, W, C, Co;
};

// grid (ceil(W / TW) * Co / BN, H, B)
__global__ void __launch_bounds__(kThreads) gn_conv_kernel(const ConvArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* halo = smem;                    // [2][3][kHaloCols][kRow]
  unsigned char* wsm = smem + 2 * kHaloBytes;    // [2][BN][kRow]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;       // 2 x 4 warps of 32 pixels x 32 channels
  const int gq = lane >> 2, tq = lane & 3;
  const int H = g.H, W = g.W, C = g.C, Co = g.Co;
  const int wtiles = (W + TW - 1) / TW;
  const int n0 = (blockIdx.x / wtiles) * BN, w0 = (blockIdx.x % wtiles) * TW;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nchunks = C / CK, nsteps = 9 * nchunks;

  // halo piece i: row r (input row h + r - 1), column col (input column
  // w0 + col - 1), 8 channels at 8 * part of the chunk
  auto piece = [&](int i, int& off, size_t& src) {
    const int part = i % (CK / 8), pc = i / (CK / 8);
    const int r = pc / kHaloCols, col = pc % kHaloCols;
    const int hh = h + r - 1, ww = w0 + col - 1;
    off = pc * kRow + part * 16;
    src = ((static_cast<size_t>(b) * H + hh) * W + ww) * C + part * 8;
    return hh >= 0 && hh < H && ww >= 0 && ww < W;
  };
  auto load_halo = [&](int cc) {
    unsigned char* buf = halo + (cc & 1) * kHaloBytes;
    for (int i = tid; i < kHaloPieces; i += kThreads) {
      int off;
      size_t src;
      if (piece(i, off, src))
        cp_async16(buf + off, g.x + src + cc * CK);
      else   // the conv's zero ring: zeros of the activated tensor
        *reinterpret_cast<uint4*>(buf + off) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // normalise + swish + round, in place, the pieces this thread copied
  // (its own cp.async writes are visible to it after the wait)
  auto activate_halo = [&](int cc) {
    unsigned char* buf = halo + (cc & 1) * kHaloBytes;
    for (int i = tid; i < kHaloPieces; i += kThreads) {
      int off;
      size_t src;
      if (!piece(i, off, src)) continue;
      const int c = cc * CK + (i % (CK / 8)) * 8;
      const float* sc = g.scale + static_cast<size_t>(b) * C + c;
      const float* sh = g.shift + static_cast<size_t>(b) * C + c;
      uint4 v = *reinterpret_cast<const uint4*>(buf + off);
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(e[k]);
        e[k] = __floats2bfloat162_rn(gn_swish(f.x, sc[2 * k], sh[2 * k]),
                                     gn_swish(f.y, sc[2 * k + 1], sh[2 * k + 1]));
      }
      *reinterpret_cast<uint4*>(buf + off) = v;
    }
  };
  auto load_w = [&](int step) {
    const int cc = step / 9, tap = step - 9 * cc;
    unsigned char* buf = wsm + (step & 1) * kWBytes;
    for (int i = tid; i < BN * (CK / 8); i += kThreads) {
      const int n = i / (CK / 8), part = i % (CK / 8);
      cp_async16(buf + n * kRow + part * 16,
                 g.w + (static_cast<size_t>(n0 + n) * 9 + tap) * C + cc * CK + part * 8);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  load_halo(0);
  load_w(0);
  cp_async_commit();
  for (int step = 0; step < nsteps; ++step) {
    const int cc = step / 9, tap = step - 9 * cc;
    // the next weight tile and, at a chunk's first tap, the next chunk's halo
    if (step + 1 < nsteps) load_w(step + 1);
    if (tap == 0 && cc + 1 < nchunks) load_halo(cc + 1);
    cp_async_commit();
    cp_async_wait<1>();     // all but the group just committed: W(step), halo(cc)
    if (tap == 0) activate_halo(cc);
    __syncthreads();

    const int dy = tap / 3, dx = tap - 3 * dy;
    const unsigned char* As = halo + (cc & 1) * kHaloBytes + (dy * kHaloCols + dx) * kRow;
    const unsigned char* Bs = wsm + (step & 1) * kWBytes;
#pragma unroll
    for (int ks = 0; ks < CK / 16; ++ks) {
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* bp = Bs + (wn * 32 + j * 8 + gq) * kRow + ks * 32 + tq * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(bp);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // output pixel p of the strip reads halo column p + dx of row dy
        const unsigned char* ap = As + (wm * 32 + i * 16 + gq) * kRow + ks * 32 + tq * 4;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(ap);
        af[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * kRow);
        af[2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * kRow + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();        // this step's tiles consumed before they are refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int w = w0 + wm * 32 + i * 16 + gq + hf * 8;
      if (w >= W) continue;
      __nv_bfloat16* yrow = g.y + ((static_cast<size_t>(b) * H + h) * W + w) * Co;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + tq * 2;
        *reinterpret_cast<__nv_bfloat162*>(yrow + n) =
            __floats2bfloat162_rn(__fadd_rn(acc[i][j][2 * hf], g.bias[n]),
                                  __fadd_rn(acc[i][j][2 * hf + 1], g.bias[n + 1]));
      }
    }
}

}  // namespace

// Pixels of an image per statistics block: the wrapper sizes the partial
// sums' scratch with it.
extern "C" int t2s_gn_stat_pixels() { return kStatPix; }

// y (B, H, W, Co) bf16 = conv3x3(swish(GroupNorm(x; gamma, beta)), w) + bias
// for x (B, H, W, C) bf16, gamma / beta (C,) f32, w (Co, 9, C) bf16, bias
// (Co,) f32, `groups` groups. Scratch: partial (B, ceil(H*W / 256), 2,
// groups) f32 and scale_shift (2, B, C) f32. Three launches on `stream`.
// Returns the CUDA error code.
extern "C" int t2s_gn_swish_conv(const void* x, const void* gamma, const void* beta,
                                 const void* w, const void* bias, void* y, void* partial,
                                 void* scale_shift, int B, int H, int W, int C, int Co,
                                 int groups, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || H > 65535 || C <= 0 || C % CK != 0 ||
      C > kMaxC || Co <= 0 || Co % BN != 0 || groups <= 0 || C % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W, nchunk = (HW + kStatPix - 1) / kStatPix;
  float* part = static_cast<float*>(partial);
  float* scale = static_cast<float*>(scale_shift);
  float* shift = scale + static_cast<size_t>(B) * C;
  gn_stats_kernel<<<dim3(nchunk, B), kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), HW,
                                                        C, groups, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gn_finalize_kernel<<<B, kThreads, 0, s>>>(part, nchunk, C, groups,
                                            static_cast<float>(HW) * (C / groups),
                                            static_cast<const float*>(gamma),
                                            static_cast<const float*>(beta), scale, shift);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool attr_set = false;
  if (!attr_set) {
    e = cudaFuncSetAttribute(gn_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  ConvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.scale = scale;
  a.shift = shift;
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.H = H;
  a.W = W;
  a.C = C;
  a.Co = Co;
  const dim3 grid(((W + TW - 1) / TW) * (Co / BN), H, B);
  gn_conv_kernel<<<grid, kThreads, kSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
