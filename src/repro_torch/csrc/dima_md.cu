// DIMA Manhattan-distance mode on Hopper: dual-rail functional read —
// BL develops f(D + P~), BLB the complementary f(D~ + P) — comparator with
// offset noise picks the deeper swing, minus vref, clamp >= 0, CBLP mean,
// cycle mean, 8-b ADC (+ optional fused calibration trim), for every
// (bank, query, stored row).
//
// Replaces the Pallas kernel of repro/kernels/dima_md.py: the query-batched
// grid dima_md_batch (dima_md.py:122, B x M/128 blocks) and the
// bank-leading grid dima_md_bank_batch (dima_md.py:177, NB x B x M/128).
// One kernel serves both (NB = 1 is the query-batched form).  Plain
// version: repro_torch/kernels/ref.py::dima_md_ref (+ trim_ref).
//
// What bounds it on an H100: bytes, even more than DP mode.  Each
// (query, row) output reads three 2x128 f32 noise operands — comparator
// offset, BL read, BLB read (3,072 B) — plus 2 f32 of CBLP noise, against
// ~10 kflop, about 3.3 flop/B, far below the 20 flop/B ridge
// (67 TFLOP/s f32 / 3.35 TB/s).
//
// What the design does about it: the DP kernel's layout — one warp per
// output, lane l on columns 4l..4l+3 of both cycles, three pairs of
// 16-byte streaming loads per lane (each a coalesced 512 B sweep of the
// warp), the 128-column means kept in registers and finished with a
// shuffle butterfly, no shared memory.
//
// Parity: the JAX kernel's operation order, --fmad=false, rintf, f32
// v_range and ep; only the column-sum order differs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // outputs per 256-thread block
constexpr int kCols = 128;       // words per access cycle
constexpr unsigned kAll = 0xffffffffu;

struct Consts {
  float delta_v;     // V per LSB of a 4-b sub-word
  float md_beta;     // replica-add regime curvature
  float gain;        // md_gain: volts per unit of mean(|D-P|)
  float dims;        // dims per conversion (256)
  float full;        // 2^adc_bits - 1
};

__device__ __forceinline__ float transfer(float c, float dv, float beta) {
  return dv * c * (1.0f - beta * c);
}

// 16-byte (4 x f32) and 4-byte (4 x u8) register copies; stream4 marks the
// load evict-first, for operands read exactly once (the noise)
__device__ __forceinline__ void load4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void stream4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = __ldcs(reinterpret_cast<const float4*>(src));
}
__device__ __forceinline__ void load4(uint8_t* dst, const uint8_t* src) {
  *reinterpret_cast<uchar4*>(dst) = *reinterpret_cast<const uchar4*>(src);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

// one replica-added functional read of a column pair
__device__ __forceinline__ float replica_read(int word, int rep, float r,
                                              float cg, float noise,
                                              const Consts& k) {
  const float m = (float)((word >> 4) & 0xF) + (float)((rep >> 4) & 0xF);
  const float l = (float)(word & 0xF) + (float)(rep & 0xF);
  const float vm = transfer(m, k.delta_v, k.md_beta);
  const float vl = transfer(l, k.delta_v, k.md_beta);
  return ((r * vm + vl) / (r + 1.0f)) * cg + noise;
}

template <bool kTrim>
__global__ void __launch_bounds__(kWarps * 32) dima_md_kernel(
    const uint8_t* __restrict__ d, const uint8_t* __restrict__ qs,
    const float* __restrict__ col_gain, const float* __restrict__ cap_eps,
    const float* __restrict__ cmp_noise, const float* __restrict__ read_noise,
    const float* __restrict__ read_noise_b,
    const float* __restrict__ cblp_noise, const float* __restrict__ v_range,
    const float* __restrict__ ep, int32_t* __restrict__ codes,
    float* __restrict__ volts, float* __restrict__ trimmed, int nb, int b,
    int m, Consts k) {
  const long long out = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (out >= (long long)nb * b * m) return;
  const int lane = threadIdx.x & 31;
  const int row = (int)(out % m);
  const long long bank_query = out / m;
  const int query = (int)(bank_query % b);
  const int bank = (int)(bank_query / b);
  const int col = 4 * lane;

  const uint8_t* drow = d + ((long long)bank * m + row) * (2 * kCols);
  const uint8_t* q = qs + (long long)query * (2 * kCols);
  const long long noise_row = out * (2 * kCols);

  alignas(16) float cg[4], ce[4];
  load4(cg, col_gain + col);
  load4(ce, cap_eps + col);
  const float vref = (16.0f * transfer(15.0f, k.delta_v, k.md_beta)
                      + transfer(15.0f, k.delta_v, k.md_beta)) / 17.0f;

  float sums[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const long long at = noise_row + c * kCols + col;
    alignas(16) float n_cmp[4], n_bl[4], n_blb[4];
    alignas(4) uint8_t dw[4], qw[4];
    stream4(n_cmp, cmp_noise + at);
    stream4(n_bl, read_noise + at);
    stream4(n_blb, read_noise_b + at);
    load4(dw, drow + c * kCols + col);
    load4(qw, q + c * kCols + col);
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dword = dw[e], qword = qw[e];
      const float r = 16.0f * (1.0f + ce[e]);
      // BL develops f(D + P~), BLB the complementary f(D~ + P)
      const float v_bl =
          replica_read(dword, 255 - qword, r, cg[e], n_bl[e], k);
      const float v_blb =
          replica_read(255 - dword, qword, r, cg[e], n_blb[e], k);
      const bool pick = (v_bl + n_cmp[e]) >= v_blb;
      acc += fmaxf((pick ? v_bl : v_blb) - vref, 0.0f);
    }
    sums[c] = warp_sum(acc);
  }
  if (lane != 0) return;

  const float2 cn = *reinterpret_cast<const float2*>(cblp_noise + out * 2);
  const float v0 = sums[0] / (float)kCols + cn.x;
  const float v1 = sums[1] / (float)kCols + cn.y;
  const float v = (v0 + v1) / 2.0f;

  const float lo = v_range[2 * bank], hi = v_range[2 * bank + 1];
  const float x = (v - lo) / fmaxf(hi - lo, 1e-9f);
  const float code = fminf(fmaxf(rintf(x * k.full), 0.0f), k.full);
  codes[out] = (int32_t)code;
  volts[out] = v;
  if (kTrim) {
    const float4 e = *reinterpret_cast<const float4*>(ep + (long long)query * 4);
    const float vd = lo + code / k.full * (hi - lo);
    const float dot_hat = vd / k.gain * k.dims;
    trimmed[out] = (e.x * dot_hat + e.y * e.w) + e.z;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// ep and trimmed are both null (plain outputs) or both set (fused trim).
extern "C" int dima_md_launch(
    const uint8_t* d, const uint8_t* qs, const float* col_gain,
    const float* cap_eps, const float* cmp_noise, const float* read_noise,
    const float* read_noise_b, const float* cblp_noise, const float* v_range,
    const float* ep, int32_t* codes, float* volts, float* trimmed, int nb,
    int b, int m, float delta_v, float md_beta, float gain, float dims,
    float full, void* stream) {
  const Consts k{delta_v, md_beta, gain, dims, full};
  const long long total = (long long)nb * b * m;
  const unsigned blocks = (unsigned)((total + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ep != nullptr) {
    dima_md_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
        d, qs, col_gain, cap_eps, cmp_noise, read_noise, read_noise_b,
        cblp_noise, v_range, ep, codes, volts, trimmed, nb, b, m, k);
  } else {
    dima_md_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        d, qs, col_gain, cap_eps, cmp_noise, read_noise, read_noise_b,
        cblp_noise, v_range, ep, codes, volts, trimmed, nb, b, m, k);
  }
  return (int)cudaGetLastError();
}
