// The Vreman (2004) closure in one pass: the velocity-gradient tensor
// a11..a33, aa, the six b's and bb, then ekm and ekh (modsubgrid.f90:
// 269-360), with the optional stable-stratification correction
// (:332-354).
//
// Replaces no TPU Pallas kernel: udales_tpu leaves the closure to XLA's
// fusions.  It was added because the port's closure leaf ran as ~135
// whole-field torch operations a call, about 1% of its memory bound on the
// H100 (16.4 ms a call at 512 x 512 x 128 float32 against a bound of
// 0.2 ms).  It computes exactly what udales_tpu_torch/ops/subgrid.py
// vreman_closure computes, with the same formulas in the same order:
//   a_ij  the gradients of _gradients (du_j/dx_i at the cell centre)
//   aa    = sum of a_ij^2
//   b_ij  = dx2 a1i a1j + dy2 a2i a2j + dzf2[k] a3i a3j
//   bb    = b11 b22 - b12^2 + b11 b33 - b13^2 + b22 b33 - b23^2
//   ekm   = 0 where bb < 1e-8, else c_vreman sqrt(bb / max(aa, 1e-30))
//   ekm  *= sqrt(1 - clamp(Rig, 0, Rigc) / Rigc)     (the BUOY variant)
//   ekh   = ekm / prandtl + numol / prandtlmol;  ekm += numol
// A division by a constant of the case is a product with its reciprocal
// and grav / thl is grav times 1 / thl, as PyTorch computes them on the
// card.  The source is compiled without FMA contraction (--fmad=false,
// ops/fused_vreman.py), so that every product and sum rounds as PyTorch's
// elementwise operations round it: bb subtracts products of nearly equal
// size, and the square roots of bb / aa and of 1 - Rig / Rigc would turn a
// one-ulp difference there into a large one in ekm.
//
// Inputs are the h=1 ghosted velocities of run._velocity_ghosts (or
// ops/boundary.py make_ghosts), C-contiguous with z fastest:
//   u, v  (nx+2, ny+2, nz+2)   cell arrays with one k ghost each side
//   w     (nx+2, ny+2, nz+1)   face array, no k ghost
// and, in the BUOY variant only, the interior thl and dthvdz (nx, ny, nz).
// The ghosts carry whatever the case puts there (periodic wraps, open-x or
// open-y planes, a split rank's halos): the kernel does not know which.
// Vertical metrics arrive as device vectors: dzf_g (nz+2), dzhi (nz+1),
// dzfi, dzfiq, dzf2 (nz), and dzh (nz+1) for the BUOY variant.  Outputs are
// the interior ekm and ekh (nx, ny, nz).
//
// What bounds it on the H100: bytes.  Per grid point it reads three ghosted
// fields and writes two, 20 bytes in float32 against some 150 flops, under
// the card's ~20 flop/byte balance point, so it is memory-bound at
// 3.35 TB/s.  The stencil reaches +-1 in i, j and k, as that of
// fused_diff_mom.cu, so the design is that kernel's plane ring (its notes
// have the reasons):
//
//   - A block owns a (TJ x TK) window of (j, k) and marches along i over a
//     chunk of planes; the launch grid is (k-tiles, j-tiles, i-chunks).  k
//     is fastest across threads, so every global access is a z-run.
//   - The window, halo included ((TJ+2) x (TK+2)), of u, v and w is kept in
//     shared memory for a ring of consecutive ghosted planes: the three
//     that the stencil of the current plane reads and the rest that the
//     next planes are copied into meanwhile with cp.async.  One
//     __syncthreads() a plane.
//   - The cell arrays hold ghosted z index k0 + kk at window index kk and
//     the face array w face k0 - 1 + kk, so cell k and face k of a thread
//     sit at the same offset.
//   - The metric values of a thread's k go to registers once, since k does
//     not change along the march.  thl and dthvdz are read once each, at
//     the thread's own point, straight from global memory.
//   - Threads outside the domain copy, but compute and store nothing, and
//     reach every barrier.
//
// Build report (nvcc -O3 --fmad=false -Xptxas -v for sm_90a on an H100
// 80GB HBM3): float32 56 registers, with the correction 61; float64 85 and
// 96; no spills, no stack frame, one barrier.  Resident blocks per SM by the
// occupancy calculator: 4 in float32, 2 in float64.  chip_smoke.py phase 3
// prints the report of the source it builds.

#include <cuda_runtime.h>

namespace {

// Tile of one block (TJ x TK threads), the planes in the ring and the
// least number of blocks the launcher aims for when it cuts i into chunks;
// those of fused_diff_mom.cu, whose sweep they won.
constexpr int TJ = 8, TK = 32;
constexpr int NT = TJ * TK;            // threads of a block
constexpr int WJ = TJ + 2, WK = TK + 2;
constexpr int PL = WJ * WK;            // elements of one window
constexpr int NSLOT = 5;               // planes in the ring
constexpr int AHEAD = NSLOT - 3;       // planes in flight beyond the stencil's
static_assert(AHEAD >= 1, "the ring needs a slot to copy into");
constexpr int NE = (PL + NT - 1) / NT; // window elements a thread copies
static_assert(NT <= 1024, "tile has more threads than a block can hold");
constexpr int MIN_BLOCKS = 528;
constexpr int NFIELDS = 3;             // u, v, w in the ring

// One element, global to shared, without passing through registers.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(dst), "l"(gmem), "n"(BYTES) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most PENDING of the newest committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// The constants of the case, in the field type.
template <typename T>
struct Coefs {
  T dxi, dyi, dxiq, dyiq, dx2, dy2;
  T c_vreman, prandtli, ekh_mol, numol, grav, rigc;
};

template <typename T, bool BUOY>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 2 : 1)
fused_vreman_kernel(
    const T* __restrict__ u_in, const T* __restrict__ v_in,
    const T* __restrict__ w_in, const T* __restrict__ thl,
    const T* __restrict__ dthvdz, const T* __restrict__ dzf_g,
    const T* __restrict__ dzhi, const T* __restrict__ dzfi,
    const T* __restrict__ dzfiq, const T* __restrict__ dzf2,
    const T* __restrict__ dzh, T* __restrict__ ekm_out,
    T* __restrict__ ekh_out, int nx, int ny, int nz, int ci, Coefs<T> cf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  // ring[field][slot][jj][kk]; from here on u, v and w name the windows in
  // shared memory, the *_in pointers the global arrays
  constexpr int FS = NSLOT * PL;
  T* const u = sm;
  T* const v = sm + FS;
  T* const w = sm + 2 * FS;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TK + tx;
  const int k0 = blockIdx.x * TK, j0 = blockIdx.y * TJ, i0 = blockIdx.z * ci;
  const int n = min(ci, nx - i0);      // planes this block computes
  const int k = k0 + tx, j = j0 + ty;
  const bool inside = (k < nz) && (j < ny);

  // strides of the cell arrays and of the face array w
  const long long cy = nz + 2, cx = (long long)(ny + 2) * cy;
  const long long wy = nz + 1, wx = (long long)(ny + 2) * wy;

  // What this thread copies of every plane: window elements e = tid,
  // tid + NT, ...; the in-plane global offsets, or -1 outside the arrays.
  int g_c[NE], g_w[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    const int e = tid + q * NT;
    const int jj = e / WK, kk = e - jj * WK;
    const int jg = j0 + jj;            // ghosted j
    const int kc = k0 + kk;            // ghosted k of a cell array
    const int kf = k0 - 1 + kk;        // face of w
    const bool row = (e < PL) && (jg <= ny + 1);
    g_c[q] = (row && kc <= nz + 1) ? (int)(jg * cy + kc) : -1;
    g_w[q] = (row && kf >= 0 && kf <= nz) ? (int)(jg * wy + kf) : -1;
  }
  // Copy plane pl of this block's march (ghosted plane i0 + pl) of u, v, w
  // into ring slot pl % NSLOT, as one group; beyond the last plane the
  // group is empty, so that every step commits exactly one and the groups
  // still in flight can be counted.
  auto load_plane = [&](int pl) {
    const long long oc = (long long)(i0 + pl) * cx;
    const long long ow = (long long)(i0 + pl) * wx;
    const int so = (pl % NSLOT) * PL;
    if (pl <= n + 1) {
#pragma unroll
      for (int q = 0; q < NE; ++q) {
        const int e = tid + q * NT;
        if (g_c[q] >= 0) {
          cp_async<sizeof(T)>(u + so + e, u_in + oc + g_c[q]);
          cp_async<sizeof(T)>(v + so + e, v_in + oc + g_c[q]);
        }
        if (g_w[q] >= 0)
          cp_async<sizeof(T)>(w + so + e, w_in + ow + g_w[q]);
      }
    }
    cp_async_commit();
  };

  // step s (cell i0 + s) reads planes s, s+1, s+2 of the march
#pragma unroll
  for (int pl = 0; pl < 2 + AHEAD; ++pl) load_plane(pl);

  // metrics of this thread's k, once for the whole march
  T dzf_km = 0, dzf_k = 0, dzf_kp = 0, dzhi_k = 0, dzhi_kp = 0;
  T dzfi_k = 0, dzfiq_k = 0, dzf2_k = 0, dzh_sum = 0;
  if (inside) {
    dzf_km = dzf_g[k]; dzf_k = dzf_g[k + 1]; dzf_kp = dzf_g[k + 2];
    dzhi_k = dzhi[k]; dzhi_kp = dzhi[k + 1];
    dzfi_k = dzfi[k]; dzfiq_k = dzfiq[k]; dzf2_k = dzf2[k];
    if (BUOY) dzh_sum = dzh[k + 1] + dzh[k];
  }
  const int cc = (ty + 1) * WK + (tx + 1);   // this thread's point in a window

  for (int s = 0; s < n; ++s) {
    // planes up to s + 2 have landed (the AHEAD - 1 newest groups may still
    // fly), and every thread is done with the slot that the next copy
    // overwrites (plane s - 1, read at step s - 1)
    cp_async_wait_group<AHEAD - 1>();
    __syncthreads();
    load_plane(s + 2 + AHEAD);
    if (!inside) continue;

    const int i = i0 + s;
    // window offsets of planes i-1, i, i+1 (index di + 1)
    const int po[3] = {(s % NSLOT) * PL + cc, ((s + 1) % NSLOT) * PL + cc,
                       ((s + 2) % NSLOT) * PL + cc};
    // C(u, 0, 0, -1) is cell k-1, W(0, 0, 1) face k+1 (see the header)
#define C(A, di, dj, dk) A[po[(di) + 1] + (dj) * WK + (dk)]
#define W(di, dj, dk) w[po[(di) + 1] + (dj) * WK + (dk)]

    // ---- the velocity-gradient tensor (subgrid.py _gradients) ----
    const T a11 = (C(u, 1, 0, 0) - C(u, 0, 0, 0)) * cf.dxi;
    const T a12 = (C(v, 1, 1, 0) + C(v, 1, 0, 0) - C(v, -1, 1, 0)
                   - C(v, -1, 0, 0)) * cf.dxiq;
    const T a13 = (W(1, 0, 1) + W(1, 0, 0) - W(-1, 0, 1) - W(-1, 0, 0))
                  * cf.dxiq;
    const T a21 = (C(u, 1, 1, 0) + C(u, 0, 1, 0) - C(u, 1, -1, 0)
                   - C(u, 0, -1, 0)) * cf.dyiq;
    const T a22 = (C(v, 0, 1, 0) - C(v, 0, 0, 0)) * cf.dyi;
    const T a23 = (W(0, 1, 1) + W(0, 1, 0) - W(0, -1, 1) - W(0, -1, 0))
                  * cf.dyiq;
    const T u_c = C(u, 1, 0, 0) + C(u, 0, 0, 0);
    const T a31 = (((C(u, 1, 0, 1) + C(u, 0, 0, 1)) * dzf_k + u_c * dzf_kp)
                   * dzhi_kp
                   - (u_c * dzf_km + (C(u, 1, 0, -1) + C(u, 0, 0, -1))
                      * dzf_k) * dzhi_k) * dzfiq_k;
    const T v_c = C(v, 0, 1, 0) + C(v, 0, 0, 0);
    const T a32 = (((C(v, 0, 1, 1) + C(v, 0, 0, 1)) * dzf_k + v_c * dzf_kp)
                   * dzhi_kp
                   - (v_c * dzf_km + (C(v, 0, 1, -1) + C(v, 0, 0, -1))
                      * dzf_k) * dzhi_k) * dzfiq_k;
    const T a33 = (W(0, 0, 1) - W(0, 0, 0)) * dzfi_k;

    // ---- Vreman's invariants (subgrid.py vreman_closure) ----
    const T aa = a11 * a11 + a21 * a21 + a31 * a31 + a12 * a12 + a22 * a22
                 + a32 * a32 + a13 * a13 + a23 * a23 + a33 * a33;
    const T b11 = cf.dx2 * a11 * a11 + cf.dy2 * a21 * a21
                  + dzf2_k * a31 * a31;
    const T b22 = cf.dx2 * a12 * a12 + cf.dy2 * a22 * a22
                  + dzf2_k * a32 * a32;
    const T b12 = cf.dx2 * a11 * a12 + cf.dy2 * a21 * a22
                  + dzf2_k * a31 * a32;
    const T b33 = cf.dx2 * a13 * a13 + cf.dy2 * a23 * a23
                  + dzf2_k * a33 * a33;
    const T b13 = cf.dx2 * a11 * a13 + cf.dy2 * a21 * a23
                  + dzf2_k * a31 * a33;
    const T b23 = cf.dx2 * a12 * a13 + cf.dy2 * a22 * a23
                  + dzf2_k * a32 * a33;
    const T bb = b11 * b22 - b12 * b12 + b11 * b33 - b13 * b13 + b22 * b33
                 - b23 * b23;
    // clamp(aa, min=1e-30) keeps a NaN, as torch.clamp does
    const T aa_c = aa < T(1e-30) ? T(1e-30) : aa;
    T ekm = bb < T(1e-8) ? T(0) : cf.c_vreman * sqrt(bb / aa_c);

    const long long o = ((long long)i * ny + j) * nz + k;
    if (BUOY) {
      // ---- stable-stratification correction (modsubgrid.f90:332-354) ----
      const T du0dz = T(0.5) * ((C(u, 0, 0, 1) + C(u, 1, 0, 1))
                                - (C(u, 0, 0, -1) + C(u, 1, 0, -1)))
                      / dzh_sum;
      const T dv0dz = T(0.5) * ((C(v, 0, 0, 1) + C(v, 0, 1, 1))
                                - (C(v, 0, 0, -1) + C(v, 0, 1, -1)))
                      / dzh_sum;
      const T rig = ((T(1) / thl[o]) * cf.grav) * dthvdz[o]
                    / (du0dz * du0dz + dv0dz * dv0dz + T(1e-10));
      // clamp(Rig, 0, Rigc), NaN kept
      T r = rig < T(0) ? T(0) : rig;
      r = r > cf.rigc ? cf.rigc : r;
      ekm = ekm * sqrt(T(1) - r * (T(1) / cf.rigc));
    }
#undef C
#undef W
    ekh_out[o] = ekm * cf.prandtli + cf.ekh_mol;
    ekm_out[o] = ekm + cf.numol;
  }
}

template <typename T, bool BUOY>
int launch(const void* u, const void* v, const void* w, const void* thl,
           const void* dthvdz, const void* dzf_g, const void* dzhi,
           const void* dzfi, const void* dzfiq, const void* dzf2,
           const void* dzh, void* ekm, void* ekh, int nx, int ny, int nz,
           const Coefs<T>& cf, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  // in-plane offsets are held in 32 bits
  if ((long long)(ny + 2) * (nz + 2) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((nz + TK - 1) / TK)
                          * ((ny + TJ - 1) / TJ);
  // Halve the i-chunk until the grid has MIN_BLOCKS blocks; every chunk
  // re-reads two planes, so it is not cut below eight.
  int ci = nx;
  while (ci > 8 && tiles * ((nx + ci - 1) / ci) < MIN_BLOCKS)
    ci = (ci + 1) / 2;
  const dim3 grid((nz + TK - 1) / TK, (ny + TJ - 1) / TJ, (nx + ci - 1) / ci);
  if (grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 block(TK, TJ, 1);
  const size_t smem = (size_t)NFIELDS * NSLOT * PL * sizeof(T);
  fused_vreman_kernel<T, BUOY><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (const T*)thl,
      (const T*)dthvdz, (const T*)dzf_g, (const T*)dzhi, (const T*)dzfi,
      (const T*)dzfiq, (const T*)dzf2, (const T*)dzh, (T*)ekm, (T*)ekh, nx,
      ny, nz, ci, cf);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* u, const void* v, const void* w, const void* thl,
             const void* dthvdz, const void* dzf_g, const void* dzhi,
             const void* dzfi, const void* dzfiq, const void* dzf2,
             const void* dzh, void* ekm, void* ekh, int nx, int ny, int nz,
             double dxi, double dyi, double dxiq, double dyiq, double dx2,
             double dy2, double c_vreman, double prandtli, double ekh_mol,
             double numol, double grav, double rigc, void* stream) {
  const bool buoy = thl != nullptr;
  if (buoy != (dthvdz != nullptr) || (buoy && dzh == nullptr))
    return (int)cudaErrorInvalidValue;
  const Coefs<T> cf{(T)dxi, (T)dyi, (T)dxiq, (T)dyiq, (T)dx2, (T)dy2,
                    (T)c_vreman, (T)prandtli, (T)ekh_mol, (T)numol,
                    (T)grav, (T)rigc};
  if (buoy)
    return launch<T, true>(u, v, w, thl, dthvdz, dzf_g, dzhi, dzfi, dzfiq,
                           dzf2, dzh, ekm, ekh, nx, ny, nz, cf, stream);
  return launch<T, false>(u, v, w, nullptr, nullptr, dzf_g, dzhi, dzfi,
                          dzfiq, dzf2, nullptr, ekm, ekh, nx, ny, nz, cf,
                          stream);
}

}  // namespace

// Blocks of one instantiation that fit on an SM at once (registers, shared
// memory and threads considered), or minus the cudaError.
extern "C" int fused_vreman_blocks_per_sm(int f64, int buoy) {
  auto ask = [](auto kernel, size_t elem) {
    const size_t smem = (size_t)NFIELDS * NSLOT * PL * elem;
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, NT, smem);
    return err == cudaSuccess ? blocks : -(int)err;
  };
  if (f64)
    return buoy ? ask(fused_vreman_kernel<double, true>, 8)
                : ask(fused_vreman_kernel<double, false>, 8);
  return buoy ? ask(fused_vreman_kernel<float, true>, 4)
              : ask(fused_vreman_kernel<float, false>, 4);
}

// thl and dthvdz both null: no buoyancy correction; both set (and dzh):
// the correction.
extern "C" int fused_vreman_f32(
    const void* u, const void* v, const void* w, const void* thl,
    const void* dthvdz, const void* dzf_g, const void* dzhi,
    const void* dzfi, const void* dzfiq, const void* dzf2, const void* dzh,
    void* ekm, void* ekh, int nx, int ny, int nz, double dxi, double dyi,
    double dxiq, double dyiq, double dx2, double dy2, double c_vreman,
    double prandtli, double ekh_mol, double numol, double grav, double rigc,
    void* stream) {
  return dispatch<float>(u, v, w, thl, dthvdz, dzf_g, dzhi, dzfi, dzfiq,
                         dzf2, dzh, ekm, ekh, nx, ny, nz, dxi, dyi, dxiq,
                         dyiq, dx2, dy2, c_vreman, prandtli, ekh_mol, numol,
                         grav, rigc, stream);
}

extern "C" int fused_vreman_f64(
    const void* u, const void* v, const void* w, const void* thl,
    const void* dthvdz, const void* dzf_g, const void* dzhi,
    const void* dzfi, const void* dzfiq, const void* dzf2, const void* dzh,
    void* ekm, void* ekh, int nx, int ny, int nz, double dxi, double dyi,
    double dxiq, double dyiq, double dx2, double dy2, double c_vreman,
    double prandtli, double ekh_mol, double numol, double grav, double rigc,
    void* stream) {
  return dispatch<double>(u, v, w, thl, dthvdz, dzf_g, dzhi, dzfi, dzfiq,
                          dzf2, dzh, ekm, ekh, nx, ny, nz, dxi, dyi, dxiq,
                          dyiq, dx2, dy2, c_vreman, prandtli, ekh_mol, numol,
                          grav, rigc, stream);
}
