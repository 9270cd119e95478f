// Whole-integration simulated-bifurcation kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sb_kernel.py:79 (_sb_kernel,
// launched by fused_sb_kernel's pallas_call). One launch runs n_steps
// symplectic steps of aSB / bSB / dSB for every (problem, run):
//     x += f32(a0*dt) * y;  drive = x (aSB, bSB) or sign_pm1(x) (dSB);
//     dv = drive @ Jc^T;    a_t = a0 * ((t+1) * (1/n_steps));
//     aSB:  y += dt * (dv - (x*x + (a0 - a_t)) * x)
//     bSB, dSB: y += dt * (dv - (a0 - a_t) * x); hit = |x| > 1;
//               x = clip(x, -1, 1); y = hit ? 0 : y
// The pump is derived in-kernel from the step index; there is no (T,)
// operand. Output: x_final.
//
// Bound on this card: operations. The work is 2*P*R*N^2*T operations (a
// multiply and an add per coupling per run per step) on f32 CUDA cores,
// against one read of Jc, x0, y0 and one write of x_final. At the Gset
// shape (P=1, R=256, N=2048, T=400) that is 8.6e11 operations on 21 MB:
// 12.8 ms at 67 TFLOP/s, against 6 us of HBM traffic.
//
// Design (simple and right first):
//   * grid (P, ceil(R / block_r)), 256 threads a block. Runs are
//     independent, so no block waits on another. A block integrates its
//     block_r runs in chunks of RB = TR * Q runs at a time.
//   * threads form TI (a power of two, 32..256, >= N where it can) columns
//     along the spins and TR = 256 / TI rows along the runs. Thread (ti, tr)
//     owns spins i = ti + TI*m (m < M) of the chunk's runs tr*Q + q
//     (q < Q). Its x and y live in shared memory, in slots only it touches.
//   * each step: the thread updates x and writes its drive into the
//     chunk's shared drive table drive[j * RB + run]; __syncthreads; each
//     thread sums dv over j = 0..N-1 (a warp's lanes read neighbouring
//     words of Jc^T row j and one broadcast drive word per run);
//     __syncthreads; momentum update and walls in registers.
//   * two regimes, chosen by the host from the shared-memory budget:
//     RESIDENT keeps Jc^T (N^2 floats) in shared memory for the whole
//     launch (N <= ~220); otherwise each step streams Jc^T from global
//     memory, where the 50 MB L2 holds it (16.8 MB at N = 2048, the
//     largest N taken: 8 spins a thread).
//   * ragged N and R are masked here; nothing is padded to 128.
//
// Numerics, held to the reference op for op:
//   * the elementwise update is written with __fmul_rn / __fadd_rn /
//     __fsub_rn, which nvcc never contracts into an FMA; built without
//     --use_fast_math.
//   * dv is summed by one thread per (run, spin) in the order j = 0..N-1,
//     each term a rounded multiply and a rounded add (no FMA), whatever
//     block_r, TI, Q or the regime. The plain version sums in the same
//     order, so the two are bitwise equal; results are bitwise equal
//     across block_r values and across calls. No atomics. (With another
//     order, as cuBLAS's, aSB and bSB read out other spins in ~15% of runs
//     at N = 2048: the dynamics amplify 1-ULP differences.)
//   * a spin with zero x0, y0 and a zero Jc row and column stays exactly 0
//     (every update term is a product with 0), and reads out as +1.
//
// Left for later: several blocks per run chunk at large N (P * R / block_r
// blocks is 32 for 132 SMs at the Gset shape), and reuse of each streamed
// Jc^T word by more runs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;  // the opt-in limit of one block on sm_90

enum Variant { kASB = 0, kBSB = 1, kDSB = 2 };

struct Params {
  int R;
  int N;
  int block_r;
  int n_steps;
  int variant;
  int ti;          // threads along the spins
  float c_xy;      // f32(a0 * dt)
  float dt;
  float a0;
  float inv_steps; // f32(1 / n_steps)
};

template <int M, int Q, bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
sb_kernel(const float* __restrict__ JT, const float* __restrict__ x0,
          const float* __restrict__ y0, float* __restrict__ out, Params prm) {
  extern __shared__ __align__(16) float smem[];
  const int N = prm.N, R = prm.R, TI = prm.ti;
  const int TR = kThreads / TI;
  const int RB = TR * Q;
  const int tid = threadIdx.x;
  const int ti = tid % TI, tr = tid / TI;
  const int p = blockIdx.x;
  const float* Jp = JT + (size_t)p * N * N;

  float* Js = smem;                                // RESIDENT: N * N
  float* drive = smem + (RESIDENT ? N * N : 0);    // N * RB
  float* xs = drive + N * RB;                      // M * Q * kThreads
  float* ys = xs + M * Q * kThreads;               // M * Q * kThreads
  if constexpr (RESIDENT) {
    for (int idx = tid; idx < N * N; idx += kThreads) Js[idx] = Jp[idx];
    __syncthreads();
  }

  const int r_begin = blockIdx.y * prm.block_r;
  const int r_end = min(r_begin + prm.block_r, R);
  for (int c0 = r_begin; c0 < r_end; c0 += RB) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = ti + TI * m;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int r = c0 + tr * Q + q;
        const bool valid = i < N && r < r_end;
        const size_t off = ((size_t)p * R + r) * N + i;
        const int k = (m * Q + q) * kThreads + tid;
        xs[k] = valid ? x0[off] : 0.0f;
        ys[k] = valid ? y0[off] : 0.0f;
      }
    }

    for (int t = 0; t < prm.n_steps; ++t) {
      const float a_t =
          __fmul_rn(prm.a0, __fmul_rn((float)(t + 1), prm.inv_steps));
      const float amat = __fsub_rn(prm.a0, a_t);

      // position update; publish the drive of this thread's (run, spin)s
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = ti + TI * m;
        if (i < N) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int k = (m * Q + q) * kThreads + tid;
            const float x = __fadd_rn(xs[k], __fmul_rn(prm.c_xy, ys[k]));
            xs[k] = x;
            drive[i * RB + tr * Q + q] =
                prm.variant == kDSB ? (x >= 0.0f ? 1.0f : -1.0f) : x;
          }
        }
      }
      __syncthreads();

      float acc[M][Q];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[m][q] = 0.0f;
      const float* drow = drive + tr * Q;
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        float d[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) d[q] = drow[j * RB + q];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int i = ti + TI * m;
          float jv = 0.0f;
          if (i < N) {
            if constexpr (RESIDENT) {
              jv = Js[j * N + i];
            } else {
              jv = __ldg(Jp + (size_t)j * N + i);
            }
          }
#pragma unroll
          for (int q = 0; q < Q; ++q)
            acc[m][q] = __fadd_rn(acc[m][q], __fmul_rn(jv, d[q]));
        }
      }
      __syncthreads();  // every thread has read the drive table

      // momentum update (and walls); state is private to this thread
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = ti + TI * m;
        if (i < N) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int k = (m * Q + q) * kThreads + tid;
            float x = xs[k], y = ys[k];
            const float dv = acc[m][q];
            if (prm.variant == kASB) {
              const float cubic =
                  __fmul_rn(__fadd_rn(__fmul_rn(x, x), amat), x);
              y = __fadd_rn(y, __fmul_rn(prm.dt, __fsub_rn(dv, cubic)));
            } else {
              y = __fadd_rn(
                  y, __fmul_rn(prm.dt, __fsub_rn(dv, __fmul_rn(amat, x))));
              const bool hit = fabsf(x) > 1.0f;
              x = fminf(fmaxf(x, -1.0f), 1.0f);
              if (hit) y = 0.0f;
            }
            xs[k] = x;
            ys[k] = y;
          }
        }
      }
    }

#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = ti + TI * m;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int r = c0 + tr * Q + q;
        if (i < N && r < r_end)
          out[((size_t)p * R + r) * N + i] = xs[(m * Q + q) * kThreads + tid];
      }
    }
  }
}

int smem_bytes(int N, int RB, int M, int Q, bool resident) {
  return 4 * ((resident ? N * N : 0) + N * RB + 2 * M * Q * kThreads);
}

template <int M, int Q, bool RESIDENT>
cudaError_t launch(const float* JT, const float* x0, const float* y0,
                   float* out, int P, const Params& prm,
                   cudaStream_t stream) {
  const int RB = (kThreads / prm.ti) * Q;
  const int smem = smem_bytes(prm.N, RB, M, Q, RESIDENT);
  auto kernel = sb_kernel<M, Q, RESIDENT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(P, (prm.R + prm.block_r - 1) / prm.block_r);
  kernel<<<grid, kThreads, smem, stream>>>(JT, x0, y0, out, prm);
  return cudaGetLastError();
}

template <int M, bool RESIDENT>
cudaError_t dispatch_q(int Q, const float* JT, const float* x0,
                       const float* y0, float* out, int P, const Params& prm,
                       cudaStream_t stream) {
  switch (Q) {
    case 1: return launch<M, 1, RESIDENT>(JT, x0, y0, out, P, prm, stream);
    case 2: return launch<M, 2, RESIDENT>(JT, x0, y0, out, P, prm, stream);
    case 4: return launch<M, 4, RESIDENT>(JT, x0, y0, out, P, prm, stream);
    case 8: return launch<M, 8, RESIDENT>(JT, x0, y0, out, P, prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. JT is Jc transposed per problem
// (JT[p][j][i] = Jc[p][i][j]), contiguous (P, N, N) float32; x0, y0, out are
// contiguous (P, R, N) float32. variant: 0 aSB, 1 bSB, 2 dSB. Returns a
// cudaError_t code (0 on success): the launch's own error, checked right
// after it.
extern "C" int sb_integrate(const void* JT, const void* x0, const void* y0,
                            void* out, int P, int R, int N, int variant,
                            int block_r, int n_steps, float c_xy, float dt,
                            float a0, float inv_steps, void* stream) {
  if (P <= 0 || R <= 0 || N <= 0 || N > 8 * kThreads || block_r <= 0 ||
      n_steps < 0 || variant < kASB || variant > kDSB)
    return (int)cudaErrorInvalidValue;
  if ((R + block_r - 1) / block_r > 65535) return (int)cudaErrorInvalidValue;

  // threads along the spins: the smallest power of two >= N, 32..256
  int ti = 32;
  while (ti < N && ti < kThreads) ti *= 2;
  const int TR = kThreads / ti;
  const int M = (N + ti - 1) / ti;
  int m_pow2 = 1;
  while (m_pow2 < M) m_pow2 *= 2;
  // runs a thread carries: enough for block_r, at most 8 and 64 / M
  int Q = 1;
  while (Q * TR < block_r && Q < 8 && m_pow2 * Q * 2 <= 64) Q *= 2;
  bool resident = smem_bytes(N, TR * Q, m_pow2, Q, true) <= kSmemMax;
  while (!resident && Q > 1 &&
         smem_bytes(N, TR * Q, m_pow2, Q, false) > kSmemMax)
    Q /= 2;
  if (!resident && smem_bytes(N, TR * Q, m_pow2, Q, false) > kSmemMax)
    return (int)cudaErrorInvalidValue;

  Params prm{R, N, block_r, n_steps, variant, ti, c_xy, dt, a0, inv_steps};
  const float* J = static_cast<const float*>(JT);
  const float* x = static_cast<const float*>(x0);
  const float* y = static_cast<const float*>(y0);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident) {
    if (m_pow2 != 1) return (int)cudaErrorInvalidValue;
    return (int)dispatch_q<1, true>(Q, J, x, y, o, P, prm, s);
  }
  switch (m_pow2) {
    case 1: return (int)dispatch_q<1, false>(Q, J, x, y, o, P, prm, s);
    case 2: return (int)dispatch_q<2, false>(Q, J, x, y, o, P, prm, s);
    case 4: return (int)dispatch_q<4, false>(Q, J, x, y, o, P, prm, s);
    case 8: return (int)dispatch_q<8, false>(Q, J, x, y, o, P, prm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
