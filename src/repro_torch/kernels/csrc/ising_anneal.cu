// Whole-anneal Ising kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ising_anneal.py:59 (_anneal_kernel,
// launched by fused_anneal_kernel's pallas_call). One launch runs the whole
// chip anneal: T Euler steps of
//     q = sign_pm1(v, vdd/2);  s = scales_from_cols(t, col) * drive_dt;
//     dv = (q * s) @ J^T;      v = clip(v + dv, 0, vdd)
// for every (problem, run). The schedule is derived in-kernel from the step
// index; there is no (T, N) operand.
//
// Bound on this card: operations. The work is 2*P*R*N^2*T operations (a
// multiply and an add per coupling per run per step) against a few MB of
// J / v traffic, read and written once. At the fig5 grid (P=400, R=300,
// N=64, T=1920) that is ~1.9e12 operations on 0.03 GB: the fp32 CUDA-core
// rate bounds the f32 variant, the int8 / bf16 tensor rates the others.
//
// Design (simple and right first):
//   * grid (P, ceil(R / block_r)); 8 warps per block. Each block stages its
//     problem's J into shared memory once, TRANSPOSED (Jt[j][i]), so lanes
//     that own neighbouring spins i read neighbouring words (row-major J[i][j]
//     at N=64 would put a whole warp on one bank).
//   * each warp anneals RW runs at a time; each lane keeps the voltages of
//     ceil(N/32) spins of those runs in registers, so every Jt load feeds RW
//     multiply-adds. Per step the lane computes its own column's scale (the
//     same index as its spin, so no table), writes q*s for its spins into the
//     warp's shared row (f32, or bf16 rounded RN), __syncwarp, accumulates
//     dv_i over j, and clips.
//   * int8 packs four neighbouring j into one word on both sides: Jt holds
//     words Jt4[j/4][i] of the bytes J[i][j..j+3] (zero past N), the row holds
//     each run's int8 spins j..j+3 in one word, and one __dp4a does four
//     multiply-adds, a quarter of the f32 variant's shared loads and adds.
//   * ragged N and R are masked here; nothing is padded to 128.
//   * N <= 128 (the Python wrapper raises above that).
//
// Left for later: mma / wgmma for the int8 and bf16 variants (they run on
// the CUDA cores here: f32 and bf16 as FMAs, int8 as dp4a), more runs per
// warp, and J kept in registers instead of shared memory.
//
// Numerics, held to the reference op for op:
//   * floor modulo: jnp.mod floors, C's % truncates; slot - j is negative
//     before the first refresh pass and last_sel is negative in the pre-load
//     pass, so both go through floor_mod.
//   * float32 order of scales_from_cols: age = (float)step / substeps -
//     (float)last_sel; decay = expf(-age / (C * tau)) with C * tau the f32
//     constant (640.0 by default); where(rails_off, 0, decay) * drive_dt.
//     Built without --use_fast_math so / and expf stay IEEE / libm.
//   * int8: exact int32 accumulation (dp4a), then (float)acc * drive_dt
//     (bit-identical to f32 on the unit schedule with a power-of-two
//     drive_dt).
//   * bf16: bf16 x bf16 products are exact in f32; accumulation is f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int RW = 4;  // runs a warp anneals together

enum JType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Schedule {
  int n_steps;
  int substeps;
  int cols;          // cols_per_tile, C
  int pert_enabled;
  int period_slots;
  int off_slots;
  float settle_start;  // (anneal_sweeps - settle_sweeps) * C
  int has_leak;
  float c_tau;         // C * tau_leak_sweeps as f32
  float drive_dt;
  float vdd;
  float thr;
};

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;  // b > 0
}

// scales_from_cols(step, col) * drive_dt for one column.
__device__ __forceinline__ float column_scale(int step, int col,
                                              const Schedule& sc) {
  const int C = sc.cols;
  const int slot = step / sc.substeps;  // step >= 0: truncation == floor
  const int j = floor_mod(col, C);
  const int d = floor_mod(slot - j, C);
  int last_sel = slot - d;
  const bool pre = last_sel < 0;
  if (pre) last_sel = j - C;
  bool rails_off = false;
  if (sc.pert_enabled) {
    rails_off = floor_mod(last_sel, sc.period_slots) < sc.off_slots && !pre &&
                (float)last_sel < sc.settle_start;
  }
  float decay = 1.0f;
  if (sc.has_leak) {
    const float age = (float)step / (float)sc.substeps - (float)last_sel;
    decay = expf(-age / sc.c_tau);
  }
  return (rails_off ? 0.0f : decay) * sc.drive_dt;
}

template <int JT> struct Types;
template <> struct Types<kF32> { using J = float; using S = float; };
template <> struct Types<kBF16> { using J = uint16_t; using S = uint16_t; };
template <> struct Types<kI8> { using J = int8_t; using S = int; };

// Shared-memory layout: Jt, then one row of RW runs per warp. int8 packs
// four j per word (N4 = ceil(N/4) words per spin i, per run).
template <int JT>
__host__ __device__ __forceinline__ int jt_bytes(int N) {
  using JS = typename Types<JT>::J;
  const int b = JT == kI8 ? ((N + 3) / 4) * N * 4 : N * N * (int)sizeof(JS);
  return (b + 15) & ~15;
}

template <int JT>
__host__ __device__ __forceinline__ int row_words(int N) {
  return (JT == kI8 ? (N + 3) / 4 : N) * RW;
}

__device__ __forceinline__ float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float(((uint32_t)b) << 16);  // exact
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// One lane's contribution, M = ceil(N / 32) spins per lane.
template <int JT, int M>
__global__ void __launch_bounds__(kThreads)
anneal_kernel(const typename Types<JT>::J* __restrict__ J,
              const float* __restrict__ v0, float* __restrict__ out, int R,
              int N, int block_r, Schedule sc) {
  using JS = typename Types<JT>::J;
  using SS = typename Types<JT>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  JS* Jt = reinterpret_cast<JS*>(smem);
  SS* rows = reinterpret_cast<SS*>(smem + jt_bytes<JT>(N));
  const int N4 = (N + 3) / 4;

  const int p = blockIdx.x;
  const JS* Jp = J + (size_t)p * N * N;
  if constexpr (JT == kI8) {
    int* Jt4 = reinterpret_cast<int*>(smem);
    for (int idx = threadIdx.x; idx < N4 * N; idx += blockDim.x) {
      const int jj = idx / N, i = idx - jj * N;
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jj + k;
        const uint32_t b = j < N ? (uint8_t)Jp[i * N + j] : 0u;
        w |= b << (8 * k);
      }
      Jt4[idx] = (int)w;
    }
  } else {
    for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
      const int i = idx / N, j = idx - i * N;
      Jt[j * N + i] = Jp[idx];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // row[j * RW + r]: q*s of spin j, run r; int8: row[(j/4) * RW + r] holds
  // the spins j..j+3 of run r, one byte each
  SS* row = rows + warp * row_words<JT>(N);
  const int r_begin = blockIdx.y * block_r;
  const int r_end = min(r_begin + block_r, R);
  const int n_groups = (r_end - r_begin + RW - 1) / RW;

  for (int g = warp; g < n_groups; g += kWarps) {
    const int r0 = r_begin + g * RW;
    float v[M][RW];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = lane + 32 * m;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int rr = r0 + r;
        v[m][r] = (i < N && rr < r_end)
                      ? v0[((size_t)p * R + rr) * N + i] : sc.vdd;
      }
    }

    for (int t = 0; t < sc.n_steps; ++t) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = lane + 32 * m;
        if (i < N) {
          if constexpr (JT == kI8) {
            int8_t* dst = reinterpret_cast<int8_t*>(row + (i >> 2) * RW);
#pragma unroll
            for (int r = 0; r < RW; ++r)
              dst[4 * r + (i & 3)] = v[m][r] >= sc.thr ? 1 : -1;
          } else {
            SS* dst = row + i * RW;
            const float s = column_scale(t, i, sc);
#pragma unroll
            for (int r = 0; r < RW; ++r) {
              const float sq = (v[m][r] >= sc.thr ? 1.0f : -1.0f) * s;
              if constexpr (JT == kF32) {
                reinterpret_cast<float*>(dst)[r] = sq;
              } else {
                reinterpret_cast<uint16_t*>(dst)[r] = float_to_bf16_bits(sq);
              }
            }
          }
        }
      }
      __syncwarp();

      if constexpr (JT == kI8) {
        int acc[M][RW];
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int r = 0; r < RW; ++r) acc[m][r] = 0;
        const int* Jt4 = reinterpret_cast<const int*>(Jt);
        for (int jj = 0; jj < N4; ++jj) {
          // spins of the j's past N are left unwritten; their J bytes are 0
          const int4 q = *reinterpret_cast<const int4*>(row + jj * RW);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int i = lane + 32 * m;
            const int jw = (i < N) ? Jt4[jj * N + i] : 0;
            acc[m][0] = __dp4a(jw, q.x, acc[m][0]);
            acc[m][1] = __dp4a(jw, q.y, acc[m][1]);
            acc[m][2] = __dp4a(jw, q.z, acc[m][2]);
            acc[m][3] = __dp4a(jw, q.w, acc[m][3]);
          }
        }
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int r = 0; r < RW; ++r)
            v[m][r] = fminf(fmaxf(v[m][r] + (float)acc[m][r] * sc.drive_dt,
                                  0.0f), sc.vdd);
      } else {
        float acc[M][RW];
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int r = 0; r < RW; ++r) acc[m][r] = 0.0f;
        for (int j = 0; j < N; ++j) {
          float s4[RW];
          if constexpr (JT == kF32) {
            const float4 q = *reinterpret_cast<const float4*>(row + j * RW);
            s4[0] = q.x; s4[1] = q.y; s4[2] = q.z; s4[3] = q.w;
          } else {
            const uint2 q = *reinterpret_cast<const uint2*>(row + j * RW);
            s4[0] = __uint_as_float(q.x << 16);
            s4[1] = __uint_as_float(q.x & 0xffff0000u);
            s4[2] = __uint_as_float(q.y << 16);
            s4[3] = __uint_as_float(q.y & 0xffff0000u);
          }
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int i = lane + 32 * m;
            float jv = 0.0f;
            if (i < N) {
              if constexpr (JT == kF32) {
                jv = reinterpret_cast<const float*>(Jt)[j * N + i];
              } else {
                jv = bf16_bits_to_float(
                    reinterpret_cast<const uint16_t*>(Jt)[j * N + i]);
              }
            }
#pragma unroll
            for (int r = 0; r < RW; ++r)
              acc[m][r] = fmaf(jv, s4[r], acc[m][r]);
          }
        }
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int r = 0; r < RW; ++r)
            v[m][r] = fminf(fmaxf(v[m][r] + acc[m][r], 0.0f), sc.vdd);
      }
      __syncwarp();  // every lane has read the row before it is rewritten
    }

#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = lane + 32 * m;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int rr = r0 + r;
        if (i < N && rr < r_end) out[((size_t)p * R + rr) * N + i] = v[m][r];
      }
    }
  }
}

template <int JT, int M>
cudaError_t launch(const void* J, const float* v0, float* out, int P, int R,
                   int N, int block_r, const Schedule& sc,
                   cudaStream_t stream) {
  using JS = typename Types<JT>::J;
  using SS = typename Types<JT>::S;
  const int smem =
      jt_bytes<JT>(N) + kWarps * row_words<JT>(N) * (int)sizeof(SS);
  auto kernel = anneal_kernel<JT, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(P, (R + block_r - 1) / block_r);
  kernel<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const JS*>(J), v0, out, R, N, block_r, sc);
  return cudaGetLastError();
}

template <int JT>
cudaError_t dispatch_m(const void* J, const float* v0, float* out, int P,
                       int R, int N, int block_r, const Schedule& sc,
                       cudaStream_t stream) {
  switch ((N + 31) / 32) {
    case 1: return launch<JT, 1>(J, v0, out, P, R, N, block_r, sc, stream);
    case 2: return launch<JT, 2>(J, v0, out, P, R, N, block_r, sc, stream);
    case 3: return launch<JT, 3>(J, v0, out, P, R, N, block_r, sc, stream);
    case 4: return launch<JT, 4>(J, v0, out, P, R, N, block_r, sc, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns a cudaError_t code (0 on
// success): the launch's own error, checked right after it. j_dtype: 0 f32,
// 1 bf16 (J as raw bf16 bits), 2 int8.
extern "C" int ising_anneal(const void* J, const void* v0, void* out, int P,
                            int R, int N, int j_dtype, int block_r,
                            int n_steps, int substeps, int cols,
                            int pert_enabled, int period_slots, int off_slots,
                            float settle_start, int has_leak, float c_tau,
                            float drive_dt, float vdd, float thr,
                            void* stream) {
  if (P <= 0 || R <= 0 || N <= 0 || N > 128 || block_r <= 0 || cols <= 0 ||
      substeps <= 0 || (pert_enabled && period_slots <= 0))
    return (int)cudaErrorInvalidValue;
  if ((R + block_r - 1) / block_r > 65535) return (int)cudaErrorInvalidValue;
  Schedule sc{n_steps, substeps, cols, pert_enabled, period_slots, off_slots,
              settle_start, has_leak, c_tau, drive_dt, vdd, thr};
  const float* v = static_cast<const float*>(v0);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (j_dtype) {
    case kF32: err = dispatch_m<kF32>(J, v, o, P, R, N, block_r, sc, s); break;
    case kBF16: err = dispatch_m<kBF16>(J, v, o, P, R, N, block_r, sc, s); break;
    case kI8: err = dispatch_m<kI8>(J, v, o, P, R, N, block_r, sc, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
