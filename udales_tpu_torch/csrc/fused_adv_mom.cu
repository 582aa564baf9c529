// The advection leaf of a substep in one pass: cd2 advection of u, v, w
// with the pressure-gradient terms, and cd2 advection of thl
// (modadvection.f90:103-314).
//
// Replaces no TPU Pallas kernel: udales_tpu leaves this leaf to XLA's
// fusions.  It was added because the port's captured step spent ~2.9 ms a
// step of 128^3 float32 in ~435 whole-field torch operations for it, 2.4%
// of its memory bound (PERF.md, the step by hook).  It computes exactly what
// udales_tpu_torch/ops/advection.py adv_mom computes (adv_u, adv_v,
// adv_w, adv_c2 and the -grad(p) terms that the reference embeds in
// advecu/v/w_2nd), with the same formulas in the same order:
//   du   = adv_u - (p[i] - p[i-1]) dxi
//   dv   = adv_v - (p[j] - p[j-1]) dyi
//   dw   = adv_w - (p[k] - p[k-1]) dzhi[k] at faces 1..nz-1; faces 0 and
//          nz are written as zero
//   dthl = adv_c2(thl)                       (the THL instantiation only)
//
// Inputs are the h=1 ghosted fields of ops/boundary.py make_ghosts and the
// pressure padded by one cell in x and y (run._pad_pres), all
// C-contiguous with z fastest:
//   u, v, thl  (nx+2, ny+2, nz+2)   cell arrays with one k ghost each side
//   w          (nx+2, ny+2, nz+1)   face array, no k ghost
//   gp         (nx+2, ny+2, nz)     pressure, no k ghost
// The ghosts carry whatever the case puts there (periodic wraps, open-x or
// open-y planes, a split rank's halos): the kernel does not know which.
// Vertical metrics arrive as device vectors: dzf_g (nz+2), dzhi (nz+1),
// dzhiq (nz+1), dzfi5 (nz).
//
// What bounds it on the H100: bytes.  Per grid point it reads five input
// fields (u, v, w, thl, p) and writes four, some 37 bytes in float32
// against roughly 120 flops, far below the card's ~20 flop/byte balance
// point, so it is memory-bound at 3.35 TB/s.  The design is that of
// fused_diff_mom.cu, whose plane ring reaches 55% of its bound in the
// captured step with the same +-1 reach, so that every input byte crosses
// from L2 to an SM about once:
//
//   - A block owns a (TJ x TK) window of (j, k) and marches along i over
//     a chunk of planes; the launch grid is (k-tiles, j-tiles, i-chunks).
//     k is fastest across threads, so every global access is a z-run.
//   - The window, halo included ((TJ+2) x (TK+2)), of u, v, w, p and thl is
//     kept in shared memory for a ring of consecutive ghosted planes: the
//     three that the stencil of the current plane reads (p needs only the
//     first two) and the rest that the next planes are copied into meanwhile
//     with cp.async (4-byte copies in float32: the ghosted row pitches nz+2,
//     nz+1 and nz leave rows 4-byte aligned only).  One __syncthreads() a
//     plane: it publishes the plane that has landed and frees the slot read
//     one plane earlier for the next copy.
//   - All fields share one window index: the cell arrays hold ghosted z
//     index k0 + kk at kk, the face array w face k0 - 1 + kk and p level
//     k0 - 1 + kk, so cell k, face k and level k of a thread sit at the
//     same offset.  The thread of cell k computes face k of dw; face 0 is
//     written as zero by the thread of cell 0 and face nz by the thread of
//     cell nz-1.
//   - The seven metric values of a thread's k go to registers once, since
//     k does not change along the march.
//   - Threads outside the domain copy, but compute and store nothing, and
//     reach every barrier.
//
// Build report (nvcc -O3 -Xptxas -v for sm_90a on an H100 80GB HBM3):
// float32 with thl 76 registers, without 72; float64 with thl 104, without
// 92; no spills, no stack frame, one barrier.  Resident blocks per SM by the
// occupancy calculator: 3 in float32, 2 in float64 (registers bind).
// chip_smoke.py phase 3 prints the report of the source it builds.

#include <cuda_runtime.h>

namespace {

// Tile of one block (TJ x TK threads), the planes in the ring (the three a
// plane's stencil reads and AHEAD more that are being copied ahead of it) and
// the least number of blocks the launcher aims for when it cuts i into
// chunks; those of fused_diff_mom.cu, whose sweep they won.
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

// fields in the ring: u, v, w, p, and thl when advected here
constexpr int fields(bool thl) { return thl ? 5 : 4; }

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

template <typename T, bool THL>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 2 : 1)
fused_adv_mom_kernel(
    const T* __restrict__ u_in, const T* __restrict__ v_in,
    const T* __restrict__ w_in, const T* __restrict__ p_in,
    const T* __restrict__ thl_in, const T* __restrict__ dzf_g,
    const T* __restrict__ dzhi, const T* __restrict__ dzhiq,
    const T* __restrict__ dzfi5,
    T* __restrict__ du, T* __restrict__ dv, T* __restrict__ dw,
    T* __restrict__ dthl, int nx, int ny, int nz, int ci, T dxi, T dyi,
    T dxiq, T dyiq, T dxi5, T dyi5) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  // ring[field][slot][jj][kk]; from here on u, v, w, p and thl name the
  // windows in shared memory, the *_in pointers the global arrays
  constexpr int FS = NSLOT * PL;
  T* const u = sm;
  T* const v = sm + FS;
  T* const w = sm + 2 * FS;
  T* const p = sm + 3 * FS;
  T* const thl = sm + 4 * FS;     // only when THL

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TK + tx;
  const int k0 = blockIdx.x * TK, j0 = blockIdx.y * TJ, i0 = blockIdx.z * ci;
  const int n = min(ci, nx - i0);      // planes this block computes
  const int k = k0 + tx, j = j0 + ty;
  const bool inside = (k < nz) && (j < ny);

  // strides of the cell arrays, of the face array w and of p
  const long long cy = nz + 2, cx = (long long)(ny + 2) * cy;
  const long long wy = nz + 1, wx = (long long)(ny + 2) * wy;
  const long long py = nz, px = (long long)(ny + 2) * py;

  // What this thread copies of every plane: window elements e = tid,
  // tid + NT, ...; the in-plane global offsets, or -1 outside the arrays.
  int g_c[NE], g_w[NE], g_p[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    const int e = tid + q * NT;
    const int jj = e / WK, kk = e - jj * WK;
    const int jg = j0 + jj;            // ghosted j
    const int kc = k0 + kk;            // ghosted k of a cell array
    const int kf = k0 - 1 + kk;        // face of w, level of p
    const bool row = (e < PL) && (jg <= ny + 1);
    g_c[q] = (row && kc <= nz + 1) ? (int)(jg * cy + kc) : -1;
    g_w[q] = (row && kf >= 0 && kf <= nz) ? (int)(jg * wy + kf) : -1;
    g_p[q] = (row && kf >= 0 && kf < nz) ? (int)(jg * py + kf) : -1;
  }
  // Copy plane pl of this block's march (ghosted plane i0 + pl) of every
  // field into ring slot pl % NSLOT, as one group; p's last plane is never
  // read, and beyond the last plane the group is empty, so that every step
  // commits exactly one and the groups still in flight can be counted.
  auto load_plane = [&](int pl) {
    const long long oc = (long long)(i0 + pl) * cx;
    const long long ow = (long long)(i0 + pl) * wx;
    const long long op = (long long)(i0 + pl) * px;
    const int so = (pl % NSLOT) * PL;
    if (pl <= n + 1) {
#pragma unroll
      for (int q = 0; q < NE; ++q) {
        const int e = tid + q * NT;
        if (g_c[q] >= 0) {
          cp_async<sizeof(T)>(u + so + e, u_in + oc + g_c[q]);
          cp_async<sizeof(T)>(v + so + e, v_in + oc + g_c[q]);
          if (THL) cp_async<sizeof(T)>(thl + so + e, thl_in + oc + g_c[q]);
        }
        if (g_w[q] >= 0)
          cp_async<sizeof(T)>(w + so + e, w_in + ow + g_w[q]);
        if (pl <= n && g_p[q] >= 0)
          cp_async<sizeof(T)>(p + so + e, p_in + op + g_p[q]);
      }
    }
    cp_async_commit();
  };

  // step s (cell i0 + s) reads planes s, s+1, s+2 of the march
#pragma unroll
  for (int pl = 0; pl < 2 + AHEAD; ++pl) load_plane(pl);

  // metrics of this thread's k, once for the whole march
  T dzf_km = 0, dzf_k = 0, dzf_kp = 0, dzhi_k = 0, dzhi_kp = 0;
  T dzhiq_k = 0, dzfi5_k = 0;
  if (inside) {
    dzf_km = dzf_g[k]; dzf_k = dzf_g[k + 1]; dzf_kp = dzf_g[k + 2];
    dzhi_k = dzhi[k]; dzhi_kp = dzhi[k + 1];
    dzhiq_k = dzhiq[k]; dzfi5_k = dzfi5[k];
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
    // cell arrays, the face array and p share the window index (see the
    // header): C(u, 0, 0, -1) is cell k-1, W(0, 0, 1) face k+1, P(0, 0, -1)
    // level k-1
#define C(A, di, dj, dk) A[po[(di) + 1] + (dj) * WK + (dk)]
#define W(di, dj, dk) w[po[(di) + 1] + (dj) * WK + (dk)]
#define P(di, dj, dk) p[po[(di) + 1] + (dj) * WK + (dk)]
    const long long o = ((long long)i * ny + j) * nz + k;
    const T p_c = P(0, 0, 0);

    // ---- adv_u (modadvection.f90:158-211) and -dp/dx ----
    {
      const T uc = C(u, 0, 0, 0);
      const T uxp = uc + C(u, 1, 0, 0), uxm = uc + C(u, -1, 0, 0);
      const T horiz = (uxp * uxp - uxm * uxm) * dxiq
          + ((uc + C(u, 0, 1, 0)) * (C(v, 0, 1, 0) + C(v, -1, 1, 0))
             - (uc + C(u, 0, -1, 0)) * (C(v, 0, 0, 0) + C(v, -1, 0, 0)))
            * dyiq;
      const T vert = ((C(u, 0, 0, 1) * dzf_k + uc * dzf_kp) * dzhi_kp
                      * (W(0, 0, 1) + W(-1, 0, 1))
                      - (uc * dzf_km + C(u, 0, 0, -1) * dzf_k) * dzhi_k
                      * (W(0, 0, 0) + W(-1, 0, 0))) * T(0.5) * dzfi5_k;
      du[o] = -(horiz + vert) - (p_c - P(-1, 0, 0)) * dxi;
    }
    // ---- adv_v (modadvection.f90:215-268) and -dp/dy ----
    {
      const T vc = C(v, 0, 0, 0);
      const T vyp = C(v, 0, 1, 0) + vc, vym = C(v, 0, -1, 0) + vc;
      const T horiz =
          ((C(u, 1, 0, 0) + C(u, 1, -1, 0)) * (vc + C(v, 1, 0, 0))
           - (C(u, 0, 0, 0) + C(u, 0, -1, 0)) * (vc + C(v, -1, 0, 0))) * dxiq
          + (vyp * (vc + C(v, 0, 1, 0)) - vym * (vc + C(v, 0, -1, 0))) * dyiq;
      const T vert = ((W(0, 0, 1) + W(0, -1, 1))
                      * (C(v, 0, 0, 1) * dzf_k + vc * dzf_kp) * dzhi_kp
                      - (W(0, 0, 0) + W(0, -1, 0))
                      * (C(v, 0, 0, -1) * dzf_k + vc * dzf_km) * dzhi_k)
                     * T(0.5) * dzfi5_k;
      dv[o] = -(horiz + vert) - (p_c - P(0, -1, 0)) * dyi;
    }
    // ---- adv_c2 of thl (modadvection.f90:103-155) ----
    if (THL) {
      const T c = C(thl, 0, 0, 0);
      const T horiz = (C(u, 1, 0, 0) * (C(thl, 1, 0, 0) + c)
                       - C(u, 0, 0, 0) * (C(thl, -1, 0, 0) + c)) * dxi5
                      + (C(v, 0, 1, 0) * (C(thl, 0, 1, 0) + c)
                         - C(v, 0, 0, 0) * (C(thl, 0, -1, 0) + c)) * dyi5;
      const T vert = (W(0, 0, 1) * (C(thl, 0, 0, 1) * dzf_k + c * dzf_kp)
                      * dzhi_kp
                      - W(0, 0, 0) * (C(thl, 0, 0, -1) * dzf_k + c * dzf_km)
                      * dzhi_k) * dzfi5_k;
      dthl[o] = -(horiz + vert);
    }

    // ---- adv_w (modadvection.f90:273-314) and -dp/dz at face k ----
    // cell "above" the face is cell k (C offset dk = 0), "below" is k-1
    // (dk = -1); faces 0 and nz are not advanced and get zero.
    const long long ow = ((long long)i * ny + j) * (nz + 1) + k;
    if (k == nz - 1) dw[ow + 1] = T(0);
    if (k == 0) {
      dw[ow] = T(0);
      continue;
    }
    {
      const T wc = W(0, 0, 0);
      const T term_x =
          ((W(1, 0, 0) + wc) * (dzf_km * C(u, 1, 0, 0) + dzf_k * C(u, 1, 0, -1))
           - (wc + W(-1, 0, 0))
           * (dzf_km * C(u, 0, 0, 0) + dzf_k * C(u, 0, 0, -1))) * dxiq * dzhi_k;
      const T term_y =
          ((W(0, 1, 0) + wc) * (dzf_km * C(v, 0, 1, 0) + dzf_k * C(v, 0, 1, -1))
           - (wc + W(0, -1, 0))
           * (dzf_km * C(v, 0, 0, 0) + dzf_k * C(v, 0, 0, -1))) * dyiq * dzhi_k;
      const T wzp = wc + W(0, 0, 1), wzm = wc + W(0, 0, -1);
      const T term_z = (wzp * wzp - wzm * wzm) * dzhiq_k;
      dw[ow] = -(term_x + term_y + term_z) - (p_c - P(0, 0, -1)) * dzhi_k;
    }
#undef C
#undef W
#undef P
  }
}

template <typename T, bool THL>
int launch(const void* u, const void* v, const void* w, const void* p,
           const void* thl, const void* dzf_g, const void* dzhi,
           const void* dzhiq, const void* dzfi5, void* du, void* dv,
           void* dw, void* dthl, int nx, int ny, int nz, double dxi,
           double dyi, double dxiq, double dyiq, double dxi5, double dyi5,
           void* stream) {
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
  const size_t smem = (size_t)fields(THL) * NSLOT * PL * sizeof(T);
  auto kernel = fused_adv_mom_kernel<T, THL>;
  // the dynamic shared-memory limit of this instantiation, once a device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (const T*)p, (const T*)thl,
      (const T*)dzf_g, (const T*)dzhi, (const T*)dzhiq, (const T*)dzfi5,
      (T*)du, (T*)dv, (T*)dw, (T*)dthl, nx, ny, nz, ci, (T)dxi, (T)dyi,
      (T)dxiq, (T)dyiq, (T)dxi5, (T)dyi5);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* u, const void* v, const void* w, const void* p,
             const void* thl, const void* dzf_g, const void* dzhi,
             const void* dzhiq, const void* dzfi5, void* du, void* dv,
             void* dw, void* dthl, int nx, int ny, int nz, double dxi,
             double dyi, double dxiq, double dyiq, double dxi5, double dyi5,
             void* stream) {
  if ((thl == nullptr) != (dthl == nullptr))
    return (int)cudaErrorInvalidValue;
  if (thl != nullptr)
    return launch<T, true>(u, v, w, p, thl, dzf_g, dzhi, dzhiq, dzfi5, du,
                           dv, dw, dthl, nx, ny, nz, dxi, dyi, dxiq, dyiq,
                           dxi5, dyi5, stream);
  return launch<T, false>(u, v, w, p, nullptr, dzf_g, dzhi, dzhiq, dzfi5,
                          du, dv, dw, nullptr, nx, ny, nz, dxi, dyi, dxiq,
                          dyiq, dxi5, dyi5, stream);
}

}  // namespace

// Blocks of one instantiation that fit on an SM at once (registers, shared
// memory and threads considered), or minus the cudaError.
extern "C" int fused_adv_mom_blocks_per_sm(int f64, int thl) {
  auto ask = [](auto kernel, size_t elem, int nfields) {
    const size_t smem = (size_t)nfields * NSLOT * PL * elem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          NT, smem);
    return err == cudaSuccess ? blocks : -(int)err;
  };
  if (f64)
    return thl ? ask(fused_adv_mom_kernel<double, true>, 8, fields(true))
               : ask(fused_adv_mom_kernel<double, false>, 8, fields(false));
  return thl ? ask(fused_adv_mom_kernel<float, true>, 4, fields(true))
             : ask(fused_adv_mom_kernel<float, false>, 4, fields(false));
}

// thl and dthl both null: momentum only; both set: thl advected too.
extern "C" int fused_adv_mom_f32(
    const void* u, const void* v, const void* w, const void* p,
    const void* thl, const void* dzf_g, const void* dzhi, const void* dzhiq,
    const void* dzfi5, void* du, void* dv, void* dw, void* dthl, int nx,
    int ny, int nz, double dxi, double dyi, double dxiq, double dyiq,
    double dxi5, double dyi5, void* stream) {
  return dispatch<float>(u, v, w, p, thl, dzf_g, dzhi, dzhiq, dzfi5, du, dv,
                         dw, dthl, nx, ny, nz, dxi, dyi, dxiq, dyiq, dxi5,
                         dyi5, stream);
}

extern "C" int fused_adv_mom_f64(
    const void* u, const void* v, const void* w, const void* p,
    const void* thl, const void* dzf_g, const void* dzhi, const void* dzhiq,
    const void* dzfi5, void* du, void* dv, void* dw, void* dthl, int nx,
    int ny, int nz, double dxi, double dyi, double dxiq, double dyiq,
    double dxi5, double dyi5, void* stream) {
  return dispatch<double>(u, v, w, p, thl, dzf_g, dzhi, dzhiq, dzfi5, du, dv,
                          dw, dthl, nx, ny, nz, dxi, dyi, dxiq, dyiq, dxi5,
                          dyi5, stream);
}
