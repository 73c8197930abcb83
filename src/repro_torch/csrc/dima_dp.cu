// DIMA dot-product mode on Hopper: MR-FR -> BLP capacitive multiply ->
// CBLP charge share -> 8-b ADC (+ optional fused calibration trim), for
// every (bank, query, stored row).
//
// Replaces the Pallas kernel of repro/kernels/dima_dp.py: the query-batched
// grid dima_dp_batch (dima_dp.py:136, B x M/128 blocks) and the
// bank-leading grid dima_dp_bank_batch (dima_dp.py:196, NB x B x M/128).
// One kernel serves both: the bank is the slowest index of a flat output
// index, so the query-batched form is NB = 1.  Plain version:
// repro_torch/kernels/ref.py::dima_dp_ref (+ trim_ref).
//
// What bounds it on an H100: bytes.  Each (query, row) output reads its
// own explicit noise operands — 2x128 f32 read noise (1,024 B) and 2x2 f32
// CBLP noise (16 B) — against ~8.7 kflop of f32 work, about 8 flop/B,
// below the card's ridge of 67 TFLOP/s / 3.35 TB/s = 20 flop/B.  The stored
// rows (256 B each) are shared by all queries and come from L2.
//
// What the design does about it: one warp per output, no shared memory.
// Lane l owns columns 4l..4l+3 of both access cycles, so each lane issues
// two 16-byte loads of read noise and the 32 lanes of a warp read the
// row's 1,024 B as two fully coalesced 512 B sweeps; data words, query
// words and the chip's per-column arrays are 4- and 16-byte loads on the
// same lane mapping.  The 128-column means stay in registers: each lane
// sums its 8 terms per rail and cycle, and a 5-step shuffle butterfly
// finishes the sums.  Nothing is staged, so the only traffic is the
// compulsory noise stream plus the small shared operands.  On the card
// this reaches about a third of the byte bound (PERF.md): the per-word
// f32 chain — unfused under --fmad=false, with an IEEE division and four
// int-to-float conversions per word — is the likely limit.  Making it
// faster (per-nibble lookup of the transfer terms, noise generated
// in-kernel instead of read, several rows per warp) is later work.
//
// Parity with the plain version: the operation order of each term follows
// the JAX kernel; the build passes --fmad=false so no multiply-add is
// contracted; rounding is rintf (half to even); v_range and ep are f32.
// Only the column-sum order differs (the tolerance rule in the tests).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // outputs per 256-thread block
constexpr int kCols = 128;       // words per access cycle
constexpr unsigned kAll = 0xffffffffu;

struct Consts {
  float delta_v;     // V per LSB of a 4-b sub-word
  float inl_beta;    // functional-read curvature
  float mult_beta;   // BLP multiplier compression
  float gain;        // dp_gain: volts per unit of mean(D.P)
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

template <bool kTrim>
__global__ void __launch_bounds__(kWarps * 32) dima_dp_kernel(
    const uint8_t* __restrict__ d, const uint8_t* __restrict__ qs,
    const float* __restrict__ col_gain, const float* __restrict__ cap_eps,
    const float* __restrict__ mult_gain, const float* __restrict__ mult_off,
    const float* __restrict__ read_noise, const float* __restrict__ cblp_noise,
    const float* __restrict__ v_range, const float* __restrict__ ep,
    int32_t* __restrict__ codes, float* __restrict__ volts,
    float* __restrict__ trimmed, int nb, int b, int m, Consts k) {
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
  const float* rn = read_noise + out * (2 * kCols);

  alignas(16) float cg[4], ce[4], mg0[4], mg1[4], mo0[4], mo1[4];
  load4(cg, col_gain + col);
  load4(ce, cap_eps + col);
  load4(mg0, mult_gain + col);
  load4(mg1, mult_gain + kCols + col);
  load4(mo0, mult_off + col);
  load4(mo1, mult_off + kCols + col);

  float sum_m[2], sum_l[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    alignas(16) float noise[4];
    alignas(4) uint8_t dw[4], qw[4];
    stream4(noise, rn + c * kCols + col);
    load4(dw, drow + c * kCols + col);
    load4(qw, q + c * kCols + col);
    float acc_m = 0.0f, acc_l = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // MR-FR: PWM transfer per 4-b sub-word + 16:1 sub-range merge
      const float wm = (float)((dw[e] >> 4) & 0xF);
      const float wl = (float)(dw[e] & 0xF);
      const float vm = transfer(wm, k.delta_v, k.inl_beta);
      const float vl = transfer(wl, k.delta_v, k.inl_beta);
      const float r = 16.0f * (1.0f + ce[e]);        // trim-cap ratio error
      float v_word = (r * vm + vl) / (r + 1.0f);
      v_word = v_word * cg[e] + noise[e];
      // BLP: two parallel 4-b capacitive multipliers (P sub-ranged)
      const float pm = (float)((qw[e] >> 4) & 0xF);
      const float pl = (float)(qw[e] & 0xF);
      const float rail_m = v_word * (pm / 16.0f) * (1.0f - k.mult_beta * pm) * mg0[e]
                           + mo0[e] * (pm > 0.0f ? 1.0f : 0.0f);
      const float rail_l = v_word * (pl / 16.0f) * (1.0f - k.mult_beta * pl) * mg1[e]
                           + mo1[e] * (pl > 0.0f ? 1.0f : 0.0f);
      acc_m += rail_m;
      acc_l += rail_l;
    }
    sum_m[c] = warp_sum(acc_m);
    sum_l[c] = warp_sum(acc_l);
  }
  if (lane != 0) return;

  // CBLP: column charge-share (mean), cycle merge, 16:1 rail merge;
  // cblp noise row is [cycle][rail]
  const float4 cn = *reinterpret_cast<const float4*>(cblp_noise + out * 4);
  const float vm0 = sum_m[0] / (float)kCols + cn.x;
  const float vl0 = sum_l[0] / (float)kCols + cn.y;
  const float vm1 = sum_m[1] / (float)kCols + cn.z;
  const float vl1 = sum_l[1] / (float)kCols + cn.w;
  const float v = (16.0f * ((vm0 + vm1) / 2.0f) + (vl0 + vl1) / 2.0f) / 17.0f;

  // ADC (8-b single-slope), one window per bank
  const float lo = v_range[2 * bank], hi = v_range[2 * bank + 1];
  const float x = (v - lo) / fmaxf(hi - lo, 1e-9f);
  const float code = fminf(fmaxf(rintf(x * k.full), 0.0f), k.full);
  codes[out] = (int32_t)code;
  volts[out] = v;
  if (kTrim) {
    // fused calibration epilogue, pipeline.trim_epilogue's order;
    // ep row: [c0, c1, c2, sum(q)]
    const float4 e = *reinterpret_cast<const float4*>(ep + (long long)query * 4);
    const float vd = lo + code / k.full * (hi - lo);
    const float dot_hat = vd / k.gain * k.dims;
    trimmed[out] = (e.x * dot_hat + e.y * e.w) + e.z;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// ep and trimmed are both null (plain outputs) or both set (fused trim).
extern "C" int dima_dp_launch(
    const uint8_t* d, const uint8_t* qs, const float* col_gain,
    const float* cap_eps, const float* mult_gain, const float* mult_off,
    const float* read_noise, const float* cblp_noise, const float* v_range,
    const float* ep, int32_t* codes, float* volts, float* trimmed, int nb,
    int b, int m, float delta_v, float inl_beta, float mult_beta, float gain,
    float dims, float full, void* stream) {
  const Consts k{delta_v, inl_beta, mult_beta, gain, dims, full};
  const long long total = (long long)nb * b * m;
  const unsigned blocks = (unsigned)((total + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ep != nullptr) {
    dima_dp_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
        d, qs, col_gain, cap_eps, mult_gain, mult_off, read_noise, cblp_noise,
        v_range, ep, codes, volts, trimmed, nb, b, m, k);
  } else {
    dima_dp_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        d, qs, col_gain, cap_eps, mult_gain, mult_off, read_noise, cblp_noise,
        v_range, ep, codes, volts, trimmed, nb, b, m, k);
  }
  return (int)cudaGetLastError();
}
