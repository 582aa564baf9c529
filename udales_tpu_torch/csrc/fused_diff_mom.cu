// SGS momentum diffusion du, dv, dw in one pass (modsubgrid.f90:672-997).
//
// Replaces the TPU Pallas kernel `fused_diff_mom`
// (udales_tpu/ops/pallas_stencil.py:191, pallas_call at :344).  It computes
// exactly what the plain sweeps udales_tpu_torch/ops/subgrid.py diff_u,
// diff_v and diff_w compute, with the same formulas in the same order.
//
// Inputs are the h=1 ghosted fields of ops/boundary.py, all C-contiguous
// with z fastest:
//   u, v, ekm  (nx+2, ny+2, nz+2)   cell arrays with one k ghost each side
//   w          (nx+2, ny+2, nz+1)   face array, no k ghost
// Outputs: du, dv (nx, ny, nz) and dw (nx, ny, nz+1) with faces 0 and nz
// written as zero.  Vertical metrics arrive as device vectors:
//   dzf_g (nz+2), dzhiq (nz+1), dzhi (nz+1), dzfi_g (nz+2); dzfi[k] is
//   read as dzfi_g[k+1], which holds the same value.
//
// What bounds it on the H100: bytes.  Per grid point it reads about four
// input fields (u, v, w, ekm) and writes three, some 28 bytes in float32
// against roughly 150 flops, far below the card's ~20 flop/byte balance
// point, so it is memory-bound at 3.35 TB/s.  The design's one aim is that
// every input byte crosses from L2 to an SM about once:
//
//   - A block owns a (TJ x TK) window of (j, k) and marches along i over
//     a chunk of planes; the launch grid is (k-tiles, j-tiles, i-chunks).
//     k is fastest across threads, so every global access is a z-run.
//   - The window, halo included ((TJ+2) x (TK+2)), of each input field is
//     kept in shared memory for a ring of consecutive ghosted planes: three
//     that the stencil of the current plane reads (every reference has
//     offsets di, dj, dk in {-1, 0, 1}) and the rest that the next planes
//     are copied into meanwhile with cp.async (4-byte copies in float32:
//     the ghosted row pitches nz+2 and nz+1 leave rows 4-byte aligned, so
//     neither 16-byte copies nor a TMA tensor map apply).  One
//     __syncthreads() a plane: it publishes the plane that has landed and
//     frees the slot read one plane earlier for the next copy.
//   - All fields share one window index: cell arrays hold ghosted z index
//     k0 + kk at kk, the face arrays w and pmask_w hold face k0 - 1 + kk,
//     so cell k and face k of a thread sit at the same offset.  The thread
//     of cell k computes face k of dw; face 0 is written as zero by the
//     thread of cell 0 and face nz by the thread of cell nz-1, so nz+1
//     faces need no extra tile.
//   - The eight metric values of a thread's k go to registers once, since
//     k does not change along the march.
//   - Threads outside the domain copy nothing, compute nothing and store
//     nothing, but reach every barrier.
//
// The TPU kernel's z-roll with its k = 0 / nz-1 epilogue and its nz % 128
// gate were lane-layout workarounds and are not carried over.
//
// The masked variant (MASKED = true, entry points fused_diff_mom_masked_*)
// is the urban path: it also takes the ghosted IBM fluid masks pmask_u,
// pmask_v (the u/v cell layout) and pmask_w ((nx+2, ny+2, nz+2), index k
// is face k, one fluid ghost face on top) and multiplies each wall-normal
// velocity gradient of a lateral or vertical flux by the opposite point's
// mask, which folds the reference's diffu/v/w_corr (modibm.f90:990-1117)
// into the sweep exactly as the plain diff_u/v/w(M=...) do.  It keeps
// three more fields in the ring; the unmasked instantiation has none of
// that code.

#include <cuda_runtime.h>

namespace {

// Tile of one block (TJ x TK threads), the planes in the ring (the three a
// plane's stencil reads and AHEAD more that are being copied ahead of it) and
// the least number of blocks the launcher aims for when it cuts i into
// chunks: four for each of the 132 SMs of an H100, where three float32
// blocks are resident.  These are the best of a sweep over tiles, rings and
// chunk lengths at 128^3 and 256^3 float32, both variants, on an H100; the
// sweep is flat within ~10%.
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

template <typename T, bool MASKED>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 2 : 1)
fused_diff_mom_kernel(
    const T* __restrict__ u_in, const T* __restrict__ v_in,
    const T* __restrict__ w_in, const T* __restrict__ ekm_in,
    const T* __restrict__ pmu_in, const T* __restrict__ pmv_in,
    const T* __restrict__ pmw_in, const T* __restrict__ dzf_g,
    const T* __restrict__ dzhiq, const T* __restrict__ dzhi,
    const T* __restrict__ dzfi_g,
    T* __restrict__ du, T* __restrict__ dv, T* __restrict__ dw,
    int nx, int ny, int nz, int ci, T dxi, T dyi, T dx2i, T dy2i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  // ring[field][slot][jj][kk]; from here on u, v, w, ekm and the masks name
  // the windows in shared memory, the *_in pointers the global arrays
  constexpr int FS = NSLOT * PL;
  T* const u = sm;
  T* const v = sm + FS;
  T* const w = sm + 2 * FS;
  T* const ekm = sm + 3 * FS;
  T* const pm_u = sm + 4 * FS;   // the last three only when MASKED
  T* const pm_v = sm + 5 * FS;
  T* const pm_w = sm + 6 * FS;

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
  int g_c[NE], g_w[NE], g_pw[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    const int e = tid + q * NT;
    const int jj = e / WK, kk = e - jj * WK;
    const int jg = j0 + jj;            // ghosted j
    const int kc = k0 + kk;            // ghosted k of a cell array
    const int kf = k0 - 1 + kk;        // face of w, z index of pmask_w
    const bool row = (e < PL) && (jg <= ny + 1);
    g_c[q] = (row && kc <= nz + 1) ? (int)(jg * cy + kc) : -1;
    g_w[q] = (row && kf >= 0 && kf <= nz) ? (int)(jg * wy + kf) : -1;
    g_pw[q] = (row && kf >= 0 && kf <= nz + 1) ? (int)(jg * cy + kf) : -1;
  }
  // Copy plane p of this block's march (ghosted plane i0 + p) of every field
  // into ring slot p % NSLOT, as one group; beyond the last plane the group
  // is empty, so that every step commits exactly one and the groups still
  // in flight can be counted.
  auto load_plane = [&](int p) {
    const long long pc = (long long)(i0 + p) * cx;
    const long long pw = (long long)(i0 + p) * wx;
    const int so = (p % NSLOT) * PL;
    if (p <= n + 1) {
#pragma unroll
      for (int q = 0; q < NE; ++q) {
        const int e = tid + q * NT;
        if (g_c[q] >= 0) {
          cp_async<sizeof(T)>(u + so + e, u_in + pc + g_c[q]);
          cp_async<sizeof(T)>(v + so + e, v_in + pc + g_c[q]);
          cp_async<sizeof(T)>(ekm + so + e, ekm_in + pc + g_c[q]);
          if (MASKED) {
            cp_async<sizeof(T)>(pm_u + so + e, pmu_in + pc + g_c[q]);
            cp_async<sizeof(T)>(pm_v + so + e, pmv_in + pc + g_c[q]);
          }
        }
        if (g_w[q] >= 0)
          cp_async<sizeof(T)>(w + so + e, w_in + pw + g_w[q]);
        if (MASKED && g_pw[q] >= 0)
          cp_async<sizeof(T)>(pm_w + so + e, pmw_in + pc + g_pw[q]);
      }
    }
    cp_async_commit();
  };

  // step s (cell i0 + s) reads planes s, s+1, s+2 of the march
#pragma unroll
  for (int p = 0; p < 2 + AHEAD; ++p) load_plane(p);

  // metrics of this thread's k, once for the whole march
  T dzf_km = 0, dzf_k = 0, dzf_kp = 0, dzhiq_k = 0, dzhiq_kp = 0;
  T dzhi_k = 0, dzhi_kp = 0, dzfi_k = 0, dzfi_km = 0;
  if (inside) {
    dzf_km = dzf_g[k]; dzf_k = dzf_g[k + 1]; dzf_kp = dzf_g[k + 2];
    dzhiq_k = dzhiq[k]; dzhiq_kp = dzhiq[k + 1];
    dzhi_k = dzhi[k]; dzhi_kp = dzhi[k + 1];
    dzfi_k = dzfi_g[k + 1]; dzfi_km = dzfi_g[k];
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
    // cell arrays and face arrays share the window index (see the header)
#define C(A, di, dj, dk) A[po[(di) + 1] + (dj) * WK + (dk)]
#define W(di, dj, dk) w[po[(di) + 1] + (dj) * WK + (dk)]
    // mask of a neighbour: 1 on the unmasked path (folded away at compile
    // time)
#define MC(A, di, dj, dk) (MASKED ? C(A, di, dj, dk) : T(1))
#define MW(di, dj) (MASKED ? pm_w[po[(di) + 1] + (dj) * WK] : T(1))
    const T ekm_c = C(ekm, 0, 0, 0);
    const long long o = ((long long)i * ny + j) * nz + k;

    // ---- diff_u (modsubgrid.f90:672-775) ----
    {
      const T ekm_im = C(ekm, -1, 0, 0);
      const T emom = (dzf_km * (ekm_c + ekm_im)
                      + dzf_k * (C(ekm, 0, 0, -1) + C(ekm, -1, 0, -1))) * dzhiq_k;
      const T emop = (dzf_kp * (ekm_c + ekm_im)
                      + dzf_k * (C(ekm, 0, 0, 1) + C(ekm, -1, 0, 1))) * dzhiq_kp;
      const T empo = T(0.25) * (ekm_c + C(ekm, 0, 1, 0) + C(ekm, -1, 0, 0)
                                + C(ekm, -1, 1, 0));
      const T emmo = T(0.25) * (ekm_c + C(ekm, 0, -1, 0) + C(ekm, -1, -1, 0)
                                + C(ekm, -1, 0, 0));
      const T uc = C(u, 0, 0, 0);
      const T t_x = (ekm_c * (C(u, 1, 0, 0) - uc)
                     - ekm_im * (uc - C(u, -1, 0, 0))) * T(2.0) * dx2i;
      const T t_y = (empo * ((C(u, 0, 1, 0) - uc) * dyi * MC(pm_u, 0, 1, 0)
                             + (C(v, 0, 1, 0) - C(v, -1, 1, 0)) * dxi)
                     - emmo * ((uc - C(u, 0, -1, 0)) * dyi * MC(pm_u, 0, -1, 0)
                               + (C(v, 0, 0, 0) - C(v, -1, 0, 0)) * dxi)) * dyi;
      const T t_z = (emop * ((C(u, 0, 0, 1) - uc) * dzhi_kp * MC(pm_u, 0, 0, 1)
                             + (W(0, 0, 1) - W(-1, 0, 1)) * dxi)
                     - emom * ((uc - C(u, 0, 0, -1)) * dzhi_k * MC(pm_u, 0, 0, -1)
                               + (W(0, 0, 0) - W(-1, 0, 0)) * dxi)) * dzfi_k;
      du[o] = t_x + t_y + t_z;
    }
    // ---- diff_v (modsubgrid.f90:778-886) ----
    {
      const T ekm_jm = C(ekm, 0, -1, 0);
      const T eomm = (dzf_km * (ekm_c + ekm_jm)
                      + dzf_k * (C(ekm, 0, 0, -1) + C(ekm, 0, -1, -1))) * dzhiq_k;
      const T eomp = (dzf_kp * (ekm_c + ekm_jm)
                      + dzf_k * (C(ekm, 0, 0, 1) + C(ekm, 0, -1, 1))) * dzhiq_kp;
      const T emmo = T(0.25) * (ekm_c + ekm_jm + C(ekm, -1, -1, 0)
                                + C(ekm, -1, 0, 0));
      const T epmo = T(0.25) * (ekm_c + ekm_jm + C(ekm, 1, -1, 0)
                                + C(ekm, 1, 0, 0));
      const T vc = C(v, 0, 0, 0);
      const T t_x = (epmo * ((C(v, 1, 0, 0) - vc) * dxi * MC(pm_v, 1, 0, 0)
                             + (C(u, 1, 0, 0) - C(u, 1, -1, 0)) * dyi)
                     - emmo * ((vc - C(v, -1, 0, 0)) * dxi * MC(pm_v, -1, 0, 0)
                               + (C(u, 0, 0, 0) - C(u, 0, -1, 0)) * dyi)) * dxi;
      const T t_y = (ekm_c * (C(v, 0, 1, 0) - vc)
                     - ekm_jm * (vc - C(v, 0, -1, 0))) * T(2.0) * dy2i;
      const T t_z = (eomp * ((C(v, 0, 0, 1) - vc) * dzhi_kp * MC(pm_v, 0, 0, 1)
                             + (W(0, 0, 1) - W(0, -1, 1)) * dyi)
                     - eomm * ((vc - C(v, 0, 0, -1)) * dzhi_k * MC(pm_v, 0, 0, -1)
                               + (W(0, 0, 0) - W(0, -1, 0)) * dyi)) * dzfi_k;
      dv[o] = t_x + t_y + t_z;
    }

    // ---- diff_w (modsubgrid.f90:890-997) at face k ----
    // cell "above" the face is cell k (C offset dk = 0), "below" is k-1
    // (dk = -1); faces 0 and nz are impermeable and get zero.
    const long long ow = ((long long)i * ny + j) * (nz + 1) + k;
    if (k == nz - 1) dw[ow + 1] = T(0);
    if (k == 0) {
      dw[ow] = T(0);
      continue;
    }
    {
      const T ea = ekm_c, eb = C(ekm, 0, 0, -1);
      const T emom = (dzf_km * (ea + C(ekm, -1, 0, 0))
                      + dzf_k * (eb + C(ekm, -1, 0, -1))) * dzhiq_k;
      const T eomm = (dzf_km * (ea + C(ekm, 0, -1, 0))
                      + dzf_k * (eb + C(ekm, 0, -1, -1))) * dzhiq_k;
      const T eopm = (dzf_km * (ea + C(ekm, 0, 1, 0))
                      + dzf_k * (eb + C(ekm, 0, 1, -1))) * dzhiq_k;
      const T epom = (dzf_km * (ea + C(ekm, 1, 0, 0))
                      + dzf_k * (eb + C(ekm, 1, 0, -1))) * dzhiq_k;
      const T wc = W(0, 0, 0);
      const T t_x = (epom * ((W(1, 0, 0) - wc) * dxi * MW(1, 0)
                             + (C(u, 1, 0, 0) - C(u, 1, 0, -1)) * dzhi_k)
                     - emom * ((wc - W(-1, 0, 0)) * dxi * MW(-1, 0)
                               + (C(u, 0, 0, 0) - C(u, 0, 0, -1)) * dzhi_k)) * dxi;
      const T t_y = (eopm * ((W(0, 1, 0) - wc) * dyi * MW(0, 1)
                             + (C(v, 0, 1, 0) - C(v, 0, 1, -1)) * dzhi_k)
                     - eomm * ((wc - W(0, -1, 0)) * dyi * MW(0, -1)
                               + (C(v, 0, 0, 0) - C(v, 0, 0, -1)) * dzhi_k)) * dyi;
      const T t_z = (ea * (W(0, 0, 1) - wc) * dzfi_k
                     - eb * (wc - W(0, 0, -1)) * dzfi_km) * T(2.0) * dzhi_k;
      dw[ow] = t_x + t_y + t_z;
    }
#undef C
#undef W
#undef MC
#undef MW
  }
}

template <typename T, bool MASKED>
int launch(const void* u, const void* v, const void* w, const void* ekm,
           const void* pm_u, const void* pm_v, const void* pm_w,
           const void* dzf_g, const void* dzhiq, const void* dzhi,
           const void* dzfi_g, void* du, void* dv, void* dw,
           int nx, int ny, int nz, double dxi, double dyi, double dx2i,
           double dy2i, void* stream) {
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
  const size_t smem = (size_t)(MASKED ? 7 : 4) * NSLOT * PL * sizeof(T);
  auto kernel = fused_diff_mom_kernel<T, MASKED>;
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
      (const T*)u, (const T*)v, (const T*)w, (const T*)ekm,
      (const T*)pm_u, (const T*)pm_v, (const T*)pm_w, (const T*)dzf_g,
      (const T*)dzhiq, (const T*)dzhi, (const T*)dzfi_g,
      (T*)du, (T*)dv, (T*)dw, nx, ny, nz, ci, (T)dxi, (T)dyi, (T)dx2i,
      (T)dy2i);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of one instantiation that fit on an SM at once (registers, shared
// memory and threads considered), or minus the cudaError.
extern "C" int fused_diff_mom_blocks_per_sm(int f64, int masked) {
  auto ask = [](auto kernel, size_t elem, int fields) {
    const size_t smem = (size_t)fields * NSLOT * PL * elem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          NT, smem);
    return err == cudaSuccess ? blocks : -(int)err;
  };
  if (f64)
    return masked ? ask(fused_diff_mom_kernel<double, true>, 8, 7)
                  : ask(fused_diff_mom_kernel<double, false>, 8, 4);
  return masked ? ask(fused_diff_mom_kernel<float, true>, 4, 7)
                : ask(fused_diff_mom_kernel<float, false>, 4, 4);
}

extern "C" int fused_diff_mom_f32(
    const void* u, const void* v, const void* w, const void* ekm,
    const void* dzf_g, const void* dzhiq, const void* dzhi,
    const void* dzfi_g, void* du, void* dv, void* dw, int nx, int ny, int nz,
    double dxi, double dyi, double dx2i, double dy2i, void* stream) {
  return launch<float, false>(u, v, w, ekm, nullptr, nullptr, nullptr,
                              dzf_g, dzhiq, dzhi, dzfi_g, du, dv, dw,
                              nx, ny, nz, dxi, dyi, dx2i, dy2i, stream);
}

extern "C" int fused_diff_mom_f64(
    const void* u, const void* v, const void* w, const void* ekm,
    const void* dzf_g, const void* dzhiq, const void* dzhi,
    const void* dzfi_g, void* du, void* dv, void* dw, int nx, int ny, int nz,
    double dxi, double dyi, double dx2i, double dy2i, void* stream) {
  return launch<double, false>(u, v, w, ekm, nullptr, nullptr, nullptr,
                               dzf_g, dzhiq, dzhi, dzfi_g, du, dv, dw,
                               nx, ny, nz, dxi, dyi, dx2i, dy2i, stream);
}

extern "C" int fused_diff_mom_masked_f32(
    const void* u, const void* v, const void* w, const void* ekm,
    const void* pm_u, const void* pm_v, const void* pm_w,
    const void* dzf_g, const void* dzhiq, const void* dzhi,
    const void* dzfi_g, void* du, void* dv, void* dw, int nx, int ny, int nz,
    double dxi, double dyi, double dx2i, double dy2i, void* stream) {
  return launch<float, true>(u, v, w, ekm, pm_u, pm_v, pm_w, dzf_g, dzhiq,
                             dzhi, dzfi_g, du, dv, dw, nx, ny, nz, dxi, dyi,
                             dx2i, dy2i, stream);
}

extern "C" int fused_diff_mom_masked_f64(
    const void* u, const void* v, const void* w, const void* ekm,
    const void* pm_u, const void* pm_v, const void* pm_w,
    const void* dzf_g, const void* dzhiq, const void* dzhi,
    const void* dzfi_g, void* du, void* dv, void* dw, int nx, int ny, int nz,
    double dxi, double dyi, double dx2i, double dy2i, void* stream) {
  return launch<double, true>(u, v, w, ekm, pm_u, pm_v, pm_w, dzf_g, dzhiq,
                              dzhi, dzfi_g, du, dv, dw, nx, ny, nz, dxi, dyi,
                              dx2i, dy2i, stream);
}
