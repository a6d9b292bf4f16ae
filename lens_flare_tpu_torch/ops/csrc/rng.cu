// Threefry-2x32 counter RNG for Hopper (sm_90a): kernel H, lf_threefry.
//
// It replaces no Pallas kernel.  It replaces jax.random's threefry as XLA
// lowers it (jax's _threefry2x32_lowering, 20 rounds), which the JAX package
// draws at lens_flare_tpu/integrator/path.py:392-411 (the per-lane tape of
// every sample, keyed by fold_in of the pixel and of the sample index) and
// lens_flare_tpu/flare/starburst.py:169,179 (the falloff's split + uniform).
// The port's plain version is lens_flare_tpu_torch/_rng.py, which computes
// the same words as separate int64 PyTorch ops masked to 32 bits (torch has
// no full uint32 arithmetic): ~180 elementwise kernels a fold_in or a draw,
// each reading and writing every word in int64.  This kernel gives the same
// bits:
//
//   mode 0  fold_in  keys (n, 2), data (n,) or one word -> keys (n, 2), counter (0, data)
//   mode 1  split    one key read n times                -> keys (n, 2), counter (i >> 32, i & 0xffffffff)
//   mode 2  bits     keys (n, 2), u                      -> (n, u) int64 words y0 ^ y1 of counter j
//   mode 3  uniform  the same                            -> (n, u) float32 ((w >> 9) | 0x3F800000) - 1, >= 0
//
// with jax's partitionable counters (jax_threefry_partitionable=True): draw j
// of a key runs the counter (j >> 32, j & 0xffffffff), and a 32-bit draw is
// the XOR of the two output words.
//
// What bounds it on this card: integer operations, not bytes.  A draw is
// ~80 32-bit operations (20 rounds of add, rotate and xor, five key
// injections, the final xor and the float fill) against 4 bytes written
// (8 for int64 words) and a 16-byte key shared by u draws: at ~16.7 T int32
// operations/s (132 SMs x 64 lanes x 1.98 GHz) against 3.35 TB/s, the
// operations take ~4x the bytes' time.  So the design spends nothing on
// memory beyond one coalesced store per draw, and keeps the operations few:
// the whole chain in registers, each rotate one funnel shift
// (__funnelshift_l), the key schedule computed once per thread, no shared
// memory, nothing allocated.  One thread per draw (lane, j) with j fastest,
// so a warp's stores fill consecutive addresses; each lane's key is read by
// the u threads that draw from it, at one address, which L1 broadcasts.
// Keys and data are read by stride, so the single key that key.expand(n, 2)
// broadcasts is never copied, and a 0-d device tensor (a captured sample's
// index) is read by pointer: nothing reaches the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RNG_THREADS = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2, int r3) {
  x0 += x1;
  x1 = rotl32(x1, r0) ^ x0;
  x0 += x1;
  x1 = rotl32(x1, r1) ^ x0;
  x0 += x1;
  x1 = rotl32(x1, r2) ^ x0;
  x0 += x1;
  x1 = rotl32(x1, r3) ^ x0;
}

// Threefry-2x32, 20 rounds: the counter (x0, x1) becomes the two output words.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  four_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  four_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  four_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  four_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  four_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

// Modes 0 and 1: one thread per output key.  keys[lane * ks0 + w * ks1] is
// word w of the lane's key (int64 holding a uint32); data, when not null, is
// int64 (data_bytes 8) or int32 (4) at data[lane * ds], else data_const.
__global__ void threefry_keys_kernel(const long long* __restrict__ keys, long long ks0, long long ks1,
                                     const void* __restrict__ data, long long ds, int data_bytes,
                                     uint32_t data_const, int split, long long n,
                                     long long* __restrict__ out) {
  const long long lane = (long long)blockIdx.x * RNG_THREADS + threadIdx.x;
  if (lane >= n) return;
  const uint32_t k0 = (uint32_t)keys[lane * ks0];
  const uint32_t k1 = (uint32_t)keys[lane * ks0 + ks1];
  uint32_t x0 = 0, x1 = data_const;
  if (split) {
    x0 = (uint32_t)((unsigned long long)lane >> 32);
    x1 = (uint32_t)lane;
  } else if (data != nullptr) {
    x1 = data_bytes == 8 ? (uint32_t) static_cast<const long long*>(data)[lane * ds]
                         : (uint32_t) static_cast<const int*>(data)[lane * ds];
  }
  threefry2x32(k0, k1, x0, x1);
  reinterpret_cast<longlong2*>(out)[lane] = make_longlong2((long long)x0, (long long)x1);
}

// Modes 2 and 3: one thread per draw t = lane * u + j.
template <bool UNIFORM>
__global__ void threefry_draws_kernel(const long long* __restrict__ keys, long long ks0, long long ks1,
                                      long long n, long long u, void* __restrict__ out) {
  const unsigned long long t = (unsigned long long)blockIdx.x * RNG_THREADS + threadIdx.x;
  const unsigned long long total = (unsigned long long)n * (unsigned long long)u;
  if (t >= total) return;
  unsigned long long lane, j;
  if (total <= 0xFFFFFFFFull) {  // a 32-bit division: a 64-bit one would cost as much as the rounds
    const uint32_t t32 = (uint32_t)t, u32 = (uint32_t)u;
    lane = t32 / u32;
    j = t32 - (uint32_t)lane * u32;
  } else {
    lane = t / (unsigned long long)u;
    j = t - lane * (unsigned long long)u;
  }
  const uint32_t k0 = (uint32_t)keys[lane * ks0];
  const uint32_t k1 = (uint32_t)keys[lane * ks0 + ks1];
  uint32_t x0 = (uint32_t)(j >> 32), x1 = (uint32_t)j;
  threefry2x32(k0, k1, x0, x1);
  const uint32_t w = x0 ^ x1;
  if (UNIFORM)
    static_cast<float*>(out)[t] = fmaxf(__uint_as_float((w >> 9) | 0x3F800000u) - 1.0f, 0.0f);
  else
    static_cast<long long*>(out)[t] = (long long)w;
}

}  // namespace

// keys: (n, 2) int64 words by strides (ks0, ks1) in elements; data: see
// threefry_keys_kernel (mode 0 only); u: draws per key (modes 2 and 3); out:
// (n, 2) int64 (modes 0, 1), (n, u) int64 (mode 2) or float32 (mode 3).
extern "C" int lf_threefry(const long long* keys, long long ks0, long long ks1, const void* data,
                           long long ds, int data_bytes, long long data_const, long long n,
                           long long u, int mode, void* out, void* stream) {
  if (n < 0 || u < 0 || mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  const unsigned long long total = mode < 2 ? (unsigned long long)n : (unsigned long long)n * (unsigned long long)u;
  if (total == 0) return (int)cudaGetLastError();
  const unsigned long long blocks = (total + RNG_THREADS - 1) / RNG_THREADS;
  if (blocks > 0x7FFFFFFFull) return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)blocks;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode < 2)
    threefry_keys_kernel<<<grid, RNG_THREADS, 0, st>>>(
        keys, ks0, ks1, data, ds, data_bytes, (uint32_t)data_const, mode == 1, n, (long long*)out);
  else if (mode == 2)
    threefry_draws_kernel<false><<<grid, RNG_THREADS, 0, st>>>(keys, ks0, ks1, n, u, out);
  else
    threefry_draws_kernel<true><<<grid, RNG_THREADS, 0, st>>>(keys, ks0, ks1, n, u, out);
  return (int)cudaGetLastError();
}
