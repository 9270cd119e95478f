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
// shape (P=1, R=256, N=2048, T=400) that is 8.6e11 operations on 23 MB:
// 12.8 ms at 67 TFLOP/s, against 7 us of HBM traffic. The sum order below
// has no FMA (two FP32 instructions a term), so 25.6 ms there is the
// ceiling of any kernel that keeps it.
//
// Design: thread-block clusters along the spins. The launch geometry is
// chosen in Python (sb_launch_plan in kernels/sb_kernel.py) and checked
// here; a plan this file cannot run, or a cluster that cannot be
// co-scheduled, is refused (kRefused). sb_launch_plan takes only
// geometries whose capacity on this card (sb_cluster_capacity) is nonzero,
// so a cluster that cannot be co-scheduled marks a plan not made for this
// card: it is refused the same way on every call, never worth a retry.
//   * grid (C, ceil(R / block_r), P), cluster (C, 1, 1). A cluster owns
//     block_r runs of one problem and integrates them in passes of RC runs
//     (RC a multiple of 4, at most 64). CTA c of the cluster owns spins
//     [c*S, (c+1)*S) of those runs. Threads form (S/4) x (RC/4) tiles:
//     each owns 4 spins x 4 runs, i.e. 16 dv accumulators, and the x, y of
//     those 16 (run, spin)s in registers for the whole launch.
//   * each step: every CTA updates x for its slice and publishes the drive
//     in its own shared memory (double-buffered, so one cluster barrier a
//     step suffices); cluster.sync(); each CTA sums dv for its own spins
//     over j = 0..N-1 in tiles of TJ rows of Jc^T. Tile k's drive rows
//     (TJ x RC floats) are read from the CTA that owns those spins through
//     distributed shared memory (mapa + ld.shared::cluster) into a local
//     stage one tile ahead. Tile k's Jc^T rows come from L2 through a ring
//     of 2-4 stages, each filled by one bulk (TMA) copy that completes on
//     the stage's mbarrier: the wrapper lays Jc^T out in per-CTA panels
//     (rows j, this CTA's S columns, zero past N), so a tile is one
//     contiguous TJ x S block. Jc^T does not change between steps, so the
//     ring runs on across steps and passes.
//   * RESIDENT regime (C = 1, chosen when the whole Jc^T fits in shared
//     memory, N <= ~220): Jc^T is loaded once and the drive is read from
//     the CTA's own table; one __syncthreads a step.
//   * inner loop (ordered_rows): per j one 16-byte load of 4 Jc^T words
//     (neighbouring threads on neighbouring words) and one broadcast
//     16-byte load of 4 drive words, then 16 multiplies and 16 adds: one
//     shared-memory load for every 16 FP32 instructions. Software-
//     pipelined one row ahead (loads, then products, then adds).
//   * the plan fills the card in one wave: clusters stay within a GPC, so
//     an H100 holds 15 clusters of 8 or 7 of 9-16 at one CTA an SM
//     (cudaOccupancyMaxActiveClusters, read by sb_cluster_capacity). At
//     the Gset shape that is 7 clusters of 16 CTAs, 40 runs each: 112
//     CTAs, all resident at once. 16 clusters of 8 (128 CTAs) would run in
//     two waves and take twice as long.
// What this does about the four limits of the first design (grid (P,
// R/8), 32 blocks at Gset, L2 loads straight into a j loop, 255 registers
// and a 144-byte spill, each Jc^T word feeding 8 runs):
//   1. occupancy: spins are split over the cluster, so one run chunk fills
//      C SMs (112 of 132 at Gset, in one wave);
//   2. registers: a 4 x 4 tile and x, y in registers, at most 320 threads
//      (204 registers a thread), with no spill;
//   3. L2 latency: Jc^T tiles are staged in shared memory by TMA, up to 3
//      tiles ahead of use, instead of a dependent __ldg per term;
//   4. reuse: each Jc^T word read from L2 feeds all RC runs of the pass
//      (40 at Gset: 47 GB of L2 traffic a solve, from 215 GB).
// N up to 8192: the plan shrinks RC, TJ and the ring depth until a CTA's
// slice fits. Above ~3500 spins Jc^T (4 N^2 bytes) outgrows the 50 MB L2
// and each step streams it from HBM: slow, and right.
//
// Numerics, held to the reference op for op:
//   * the elementwise update is written with __fmul_rn / __fadd_rn /
//     __fsub_rn, which nvcc never contracts into an FMA; built without
//     --use_fast_math.
//   * dv is summed by one thread per (run, spin) in the order j = 0..N-1,
//     each term a rounded multiply and a rounded add (no FMA), whatever the
//     plan: splitting spins and runs over CTAs leaves every sum whole. The
//     plain version (ordered_matvec) sums in the same order, so the two are
//     bitwise equal, across block_r values and across calls. No atomics,
//     no split over j. Rows j >= N of the last tile are zero-filled, with a
//     zero drive: each adds +0 to a sum that is never -0, so changes no
//     bit. (With another order, as cuBLAS's, aSB and bSB read out other
//     spins in ~13% of runs at N = 2048: the dynamics amplify 1-ULP
//     differences.)
//   * ragged N and R are masked here: spins >= N and runs past the
//     cluster's range start at 0, publish a zero drive and are never
//     written. A spin with zero x0, y0 and a zero Jc row and column stays
//     exactly 0 (every update term is a product with 0), and reads out as
//     +1.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemMax = 232448;  // the opt-in limit of one block on sm_90
constexpr int kMaxThreads = 320;  // one CTA an SM, up to 204 registers
constexpr int kMaxCluster = 16;   // above 8: a non-portable cluster size
constexpr int kRunsMax = 64;

enum Variant { kASB = 0, kBSB = 1, kDSB = 2 };
enum Regime { kResident = 0, kCluster = 1 };

struct Plan {
  int regime;
  int cluster;   // C: CTAs a cluster, along the spins
  int block_r;   // runs a cluster
  int rc;        // runs a pass (multiple of 4)
  int spins;     // S: spins a CTA (multiple of 4, and of tile_j)
  int tile_j;    // TJ: rows of Jc^T a ring stage (cluster regime)
  int stages;    // ring depth (cluster regime)
  int threads;   // (S / 4) * (rc / 4)
  int smem;      // dynamic shared-memory bytes
};

struct Params {
  int R;
  int N;
  int rows;        // rows of each CTA's Jc^T panel (N; cluster: NT * TJ)
  int n_steps;
  int variant;
  float c_xy;      // f32(a0 * dt)
  float dt;
  float a0;
  float inv_steps; // f32(1 / n_steps)
  Plan plan;
};

int plan_smem(const Plan& pl, int N) {
  const int pub = 2 * pl.spins * pl.rc;
  if (pl.regime == kResident) return 4 * (N * pl.spins + pub);
  return 4 * (pl.stages * pl.tile_j * pl.spins + 2 * pl.tile_j * pl.rc + pub) +
         8 * pl.stages;  // one mbarrier a ring stage
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// The address of `p` (in this CTA's shared memory) in the shared memory
// of CTA `rank` of the cluster, and a 16-byte load from such an address.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ float4 ld_cluster4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Tile k of this CTA's panel (TJ rows of S floats, contiguous) into one
// ring stage by one bulk (TMA) copy, completing on the stage's mbarrier.
// One thread issues it.
__device__ __forceinline__ void issue_tile(float* stage, uint64_t* bar,
                                           const float* panel, int k,
                                           const Plan& pl) {
  const unsigned bytes = 4u * pl.tile_j * pl.spins;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(stage)),
         "l"(panel + (size_t)k * pl.tile_j * pl.spins), "r"(bytes),
         "r"(smem_addr(bar))
      : "memory");
}

// The 16 rounded products J[j][s] * d[j][q] of one row j: 4 spins of the
// Jc^T row times 4 runs of the drive row.
__device__ __forceinline__ void products(float (&t)[4][4], const float4 jv,
                                         const float4 dv) {
  const float jr[4] = {jv.x, jv.y, jv.z, jv.w};
  const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) t[s][q] = __fmul_rn(jr[s], dr[q]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += the products of rows 0..n-1, row by row (n >= 1), each a rounded
// add. Software-pipelined: row j+1's operands are loaded (one 16-byte load
// each) and row j's products formed before row j-1's are added, so neither
// a multiply waits on its loads nor an add on its multiply; the order of
// every sum is unchanged.
__device__ __forceinline__ void ordered_rows(float (&acc)[4][4],
                                             const float* jrow, int jstride,
                                             const float* drow, int dstride,
                                             int n) {
  float t[4][4];
  products(t, ld4(jrow), ld4(drow));
  float4 jn = ld4(jrow + (n > 1 ? jstride : 0));
  float4 dn = ld4(drow + (n > 1 ? dstride : 0));
#pragma unroll 4
  for (int j = 1; j < n; ++j) {
    const float4 jc = jn, dc = dn;
    const int jl = j + 1 < n ? j + 1 : j;  // the last row loads itself again
    jn = ld4(jrow + jl * jstride);
    dn = ld4(drow + jl * dstride);
    float tn[4][4];
    products(tn, jc, dc);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[s][q] = __fadd_rn(acc[s][q], t[s][q]);
        t[s][q] = tn[s][q];
      }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[s][q] = __fadd_rn(acc[s][q], t[s][q]);
}

template <bool RESIDENT>
__device__ __forceinline__ void sb_body(const float* __restrict__ JT,
                                        const float* __restrict__ x0,
                                        const float* __restrict__ y0,
                                        float* __restrict__ out,
                                        const Params& prm) {
  extern __shared__ __align__(16) float smem[];
  const Plan& pl = prm.plan;
  const int N = prm.N, R = prm.R, S = pl.spins, RC = pl.rc, TJ = pl.tile_j;
  const int GS = S / 4;
  const int tid = threadIdx.x;
  const int gs = tid % GS, gr = tid / GS;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = RESIDENT ? 0 : (int)cluster.block_rank();
  const int p = blockIdx.z;
  const int i0 = rank * S;
  // this CTA's panel of Jc^T: rows j, columns [i0, i0 + S), [rows][S]
  const float* panel =
      JT + ((size_t)p * pl.cluster + rank) * (size_t)prm.rows * S;

  float* pub = smem;                         // [2][S][RC] drive tables
  float* work = pub + 2 * S * RC;            // RESIDENT: Js [N][S]
  float* ring = work;                        // else [stages][TJ][S]
  float* dstage = work + pl.stages * TJ * S; //      then [2][TJ][RC]
  uint64_t* bar = reinterpret_cast<uint64_t*>(dstage + 2 * TJ * RC);
  const int NT = RESIDENT ? 0 : prm.rows / TJ;

  if constexpr (RESIDENT) {
    for (int idx = tid; idx < N * GS; idx += blockDim.x)
      reinterpret_cast<float4*>(work)[idx] =
          reinterpret_cast<const float4*>(panel)[idx];
    __syncthreads();
  } else {
    if (tid == 0) {
      for (int st = 0; st < pl.stages; ++st) mbar_init(bar + st);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
      for (int st = 0; st < pl.stages - 1; ++st)
        issue_tile(ring + st * TJ * S, bar + st, panel, st % NT, pl);
  }

  bool spin_ok[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) spin_ok[s] = i0 + 4 * gs + s < N;

  const int r_begin = blockIdx.y * pl.block_r;
  const int r_end = min(r_begin + pl.block_r, R);
  int g = 0;     // steps run by this CTA, for the drive tables' parity
  int slot = 0;         // ring stage of the next tile to consume
  unsigned phase = 0;   // parity of that stage's current use
  for (int c0 = r_begin; c0 < r_end; c0 += RC) {
    float x[4][4], y[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = i0 + 4 * gs + s;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = c0 + 4 * gr + q;
        const bool valid = spin_ok[s] && r < r_end;
        const size_t off = ((size_t)p * R + r) * N + i;
        x[s][q] = valid ? x0[off] : 0.0f;
        y[s][q] = valid ? y0[off] : 0.0f;
      }
    }

    for (int t = 0; t < prm.n_steps; ++t, ++g) {
      const float a_t =
          __fmul_rn(prm.a0, __fmul_rn((float)(t + 1), prm.inv_steps));
      const float amat = __fsub_rn(prm.a0, a_t);

      // position update; publish this thread's drive
      float* pb = pub + (g & 1) * S * RC;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float d[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[s][q] = __fadd_rn(x[s][q], __fmul_rn(prm.c_xy, y[s][q]));
          const float dq = prm.variant == kDSB
                               ? (x[s][q] >= 0.0f ? 1.0f : -1.0f)
                               : x[s][q];
          d[q] = spin_ok[s] ? dq : 0.0f;
        }
        *reinterpret_cast<float4*>(pb + (4 * gs + s) * RC + 4 * gr) =
            make_float4(d[0], d[1], d[2], d[3]);
      }

      float acc[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[s][q] = 0.0f;

      if constexpr (RESIDENT) {
        __syncthreads();
        ordered_rows(acc, work + 4 * gs, S, pb + 4 * gr, RC, N);
      } else {
        cluster.sync();  // every CTA's drive table of this step is written
        const int n4 = TJ * RC / 4;  // float4s of one drive tile
        float4 dreg[4];
        auto load_drive = [&](int k) {
          const int j0 = k * TJ, owner = j0 / S;
          const unsigned src =
              cluster_addr(pb + (j0 - owner * S) * RC, owner);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int idx = tid + u * (int)blockDim.x;
            if (idx < n4) dreg[u] = ld_cluster4(src + 16u * idx);
          }
        };
        auto store_drive = [&](int k) {
          float4* dst =
              reinterpret_cast<float4*>(dstage + (k & 1) * TJ * RC);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int idx = tid + u * (int)blockDim.x;
            if (idx < n4) dst[idx] = dreg[u];
          }
        };
        load_drive(0);
        store_drive(0);
        for (int k = 0; k < NT; ++k) {
          mbar_wait(bar + slot, phase);  // tile k has landed
          __syncthreads();  // its drive is staged; tile k-1 is done
          if (tid == 0) {   // refill the stage that tile k-1 left
            const int refill = slot == 0 ? pl.stages - 1 : slot - 1;
            issue_tile(ring + refill * TJ * S, bar + refill, panel,
                       (k + pl.stages - 1) % NT, pl);
          }
          if (k + 1 < NT) load_drive(k + 1);
          ordered_rows(acc, ring + slot * TJ * S + 4 * gs, S,
                       dstage + (k & 1) * TJ * RC + 4 * gr, RC, TJ);
          if (k + 1 < NT) store_drive(k + 1);
          if (++slot == pl.stages) {
            slot = 0;
            phase ^= 1u;
          }
        }
      }

      // momentum update (and walls); state is private to this thread
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float xv = x[s][q], yv = y[s][q];
          const float dv = acc[s][q];
          if (prm.variant == kASB) {
            const float cubic =
                __fmul_rn(__fadd_rn(__fmul_rn(xv, xv), amat), xv);
            yv = __fadd_rn(yv, __fmul_rn(prm.dt, __fsub_rn(dv, cubic)));
          } else {
            yv = __fadd_rn(
                yv, __fmul_rn(prm.dt, __fsub_rn(dv, __fmul_rn(amat, xv))));
            const bool hit = fabsf(xv) > 1.0f;
            xv = fminf(fmaxf(xv, -1.0f), 1.0f);
            if (hit) yv = 0.0f;
          }
          x[s][q] = xv;
          y[s][q] = yv;
        }
      }
    }

#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = i0 + 4 * gs + s;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = c0 + 4 * gr + q;
        if (spin_ok[s] && r < r_end) out[((size_t)p * R + r) * N + i] = x[s][q];
      }
    }
  }
  if constexpr (!RESIDENT) {
    // no copy may land after the CTA exits: drain the tiles in flight
    for (int u = 0; u < pl.stages - 1; ++u) {
      mbar_wait(bar + slot, phase);
      if (++slot == pl.stages) {
        slot = 0;
        phase ^= 1u;
      }
    }
    cluster.sync();  // no peer still reads this CTA's drive tables
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
sb_resident(const float* __restrict__ JT, const float* __restrict__ x0,
            const float* __restrict__ y0, float* __restrict__ out,
            Params prm) {
  sb_body<true>(JT, x0, y0, out, prm);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
sb_cluster(const float* __restrict__ JT, const float* __restrict__ x0,
           const float* __restrict__ y0, float* __restrict__ out,
           Params prm) {
  sb_body<false>(JT, x0, y0, out, prm);
}

bool plan_ok(const Plan& pl, int P, int R, int N) {
  if (pl.regime != kResident && pl.regime != kCluster) return false;
  if (pl.cluster < 1 || pl.cluster > kMaxCluster) return false;
  if (pl.regime == kResident && pl.cluster != 1) return false;
  if (pl.block_r < 1 || pl.rc < 4 || pl.rc > kRunsMax || pl.rc % 4) return false;
  if (pl.spins < 4 || pl.spins % 4) return false;
  if ((long long)pl.cluster * pl.spins < N) return false;
  if (pl.threads != (pl.spins / 4) * (pl.rc / 4) || pl.threads > kMaxThreads)
    return false;
  if (pl.regime == kCluster &&
      (pl.tile_j < 4 || pl.spins % pl.tile_j || pl.stages < 2 ||
       pl.stages > 4))
    return false;
  if (pl.smem != plan_smem(pl, N) || pl.smem > kSmemMax) return false;
  if ((R + pl.block_r - 1) / pl.block_r > 65535 || P > 65535) return false;
  return true;
}

using Kernel = void (*)(const float*, const float*, const float*, float*,
                       Params);

// A launch of the regime's kernel on `grid`, in clusters of `cluster`
// CTAs along x. prepare() fills it and sets the function attributes it
// needs (the opt-in shared memory; a non-portable cluster size above 8),
// and reads how many of its clusters the card holds at once
// (cudaOccupancyMaxActiveClusters). Both entry points go through it.
struct Launch {
  Kernel kernel;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

cudaError_t prepare(Launch* l, int regime, int cluster, dim3 grid,
                    int threads, int smem, cudaStream_t stream,
                    int* active) {
  l->kernel = regime == kResident ? sb_resident : sb_cluster;
  cudaError_t err = cudaFuncSetAttribute(
      l->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        l->kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  l->cfg = {};
  l->cfg.gridDim = grid;
  l->cfg.blockDim = dim3(threads, 1, 1);
  l->cfg.dynamicSmemBytes = smem;
  l->cfg.stream = stream;
  l->attr[0].id = cudaLaunchAttributeClusterDimension;
  l->attr[0].val.clusterDim.x = cluster;
  l->attr[0].val.clusterDim.y = 1;
  l->attr[0].val.clusterDim.z = 1;
  l->cfg.attrs = l->attr;
  l->cfg.numAttrs = 1;
  *active = 0;
  return cudaOccupancyMaxActiveClusters(active, (void*)l->kernel, &l->cfg);
}

// What sb_integrate returns for a refused plan (build.REFUSED).
constexpr int kRefused = -1;

}  // namespace

// Clusters of `cluster` CTAs of the regime's kernel, with `threads`
// threads and `smem` bytes of shared memory each, that the current card
// holds at once (cudaOccupancyMaxActiveClusters); minus a cudaError_t code
// on failure. The launch plan reads it (kernels/sb_kernel.py). A plain C
// entry point, loaded with ctypes, as is sb_integrate.
extern "C" int sb_cluster_capacity(int regime, int cluster, int threads,
                                   int smem) {
  if ((regime != kResident && regime != kCluster) || cluster < 1 ||
      cluster > kMaxCluster || threads < 1 || threads > kMaxThreads ||
      smem < 0 || smem > kSmemMax)
    return -(int)cudaErrorInvalidValue;
  Launch l;
  int active = 0;
  const cudaError_t err = prepare(&l, regime, cluster, dim3(cluster, 1, 1),
                                  threads, smem, nullptr, &active);
  if (err != cudaSuccess) return -(int)err;
  return active;
}

// The whole integration, one launch. JT holds Jc transposed per
// problem in per-CTA panels: contiguous (P, cluster, rows, spins) float32
// with JT[p][c][j][s] = Jc[p][c*spins + s][j], zero where c*spins + s >= N
// or j >= N; rows is N (resident) or ceil(N / tile_j) * tile_j (cluster).
// x0, y0, out are contiguous (P, R, N) float32. variant: 0 aSB, 1 bSB,
// 2 dSB. The plan's fields are those of kernels/sb_kernel.py's
// SBLaunchPlan, in its order. Returns 0 on success, kRefused (-1) for
// arguments or a plan this kernel cannot run and when no cluster of the
// plan fits on the card (checked at every launch), else the cudaError_t of
// the launch's set-up or of the launch itself, checked right after it.
extern "C" int sb_integrate(const void* JT, const void* x0, const void* y0,
                            void* out, int P, int R, int N, int rows,
                            int variant, int n_steps, float c_xy, float dt,
                            float a0, float inv_steps, int regime,
                            int cluster, int block_r, int rc, int spins,
                            int tile_j, int stages, int threads, int smem,
                            void* stream) {
  const Plan pl{regime, cluster, block_r, rc, spins, tile_j, stages,
                threads, smem};
  if (P <= 0 || R <= 0 || N <= 0 || n_steps < 0 || variant < kASB ||
      variant > kDSB || !plan_ok(pl, P, R, N))
    return kRefused;
  const int want_rows =
      regime == kResident ? N : (N + tile_j - 1) / tile_j * tile_j;
  if (rows != want_rows) return kRefused;

  const Params prm{R, N, rows, n_steps, variant, c_xy, dt, a0, inv_steps, pl};
  Launch l;
  int active = 0;
  cudaError_t err = prepare(
      &l, regime, cluster, dim3(cluster, (R + block_r - 1) / block_r, P),
      threads, smem, static_cast<cudaStream_t>(stream), &active);
  if (err != cudaSuccess) return (int)err;
  if (active == 0) return kRefused;
  err = cudaLaunchKernelEx(&l.cfg, l.kernel, static_cast<const float*>(JT),
                           static_cast<const float*>(x0),
                           static_cast<const float*>(y0),
                           static_cast<float*>(out), prm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
