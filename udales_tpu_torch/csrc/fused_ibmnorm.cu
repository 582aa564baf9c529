// The velocity and thl part of ibmnorm in one pass (modibm.f90:697-826,
// 936-987): the solid velocities and their tendencies set to zero, the solid
// thl cells filled (value and tendency) and the liberal cd2 correction of
// thl added to its tendency.
//
// Replaces no TPU Pallas kernel: udales_tpu leaves ibmnorm to XLA's
// fusions.  It was added because the port's ibmnorm leaf ran as ~110
// whole-field torch operations a substep, most on strided views of padded
// copies, at about 6% of its memory bound on the H100 (52.0 ms a step at
// 512 x 512 x 128 float32 against a bound of 2.9 ms for three substeps).
// It computes exactly what udales_tpu_torch/ibm/ibm.py
// IBM.ibmnorm_uvw_thl computes, with the same formulas in the same order:
//   du, dv, dw, m.u, m.v, m.w  times the fluid masks M.u, M.v, M.w
//   solid_fill  at a solid cell (pmask_c < 0.5) the sum of the six
//               neighbours times their pmask_c, over their count (at least
//               1), or thl_vmean (tendency 0) where the count is 0
//   the CORR variant: dthl += corr * M.c with corr the sum of the six face
//               terms of advecc2nd_corr_liberal, left to right
// The source is compiled without FMA contraction (--fmad=false,
// ops/fused_ibmnorm.py), so that every product and sum rounds as PyTorch's
// elementwise operations round it; on the card the kernel equals the plain
// route bit for bit.
//
// Inputs, C-contiguous with z fastest: the interior tendencies and m fields
// du, dv, m.u, m.v (nx, ny, nz) and dw, m.w (nx, ny, nz+1), the fluid masks
// M.u, M.v, M.w of those shapes, pmask_c (nx+2, ny+2, nz+2: the c mask with
// its periodic x/y ring, a solid ghost below and a fluid one above), and
// m.thl, dthl, c.thl, c.u, c.v either interior (nx, ny, nz) or, in the RING
// variant, with the one-cell x/y ring (nx+2, ny+2, nz) that the ranks of a
// split exchange.  Without the ring the kernel wraps x and y itself, in its
// own indexing, so that no padded copy is made; k clamps (zero gradient) in
// both, as the plain route's pad_edge does.  c.w (nx, ny, nz+1), the
// device scalar thl_vmean and the vectors dzf_g (nz+2), dzhi (nz+1), dzfi5
// (nz).  Outputs are fresh arrays of the inputs' shapes; nothing is
// written in place.
//
// What bounds it on the H100: bytes.  Per grid point it reads 16 fields and
// writes 8 (96 bytes in float32) against some 60 flops, far under the
// card's balance point, so it is memory-bound at 3.35 TB/s.  The stencil
// reaches +-1 in i, j and k, as that of fused_vreman.cu, so the design is
// that kernel's plane ring (fused_diff_mom.cu's notes have the reasons):
//
//   - A block owns a (TJ x TK) window of (j, k) and marches along i over a
//     chunk of planes; the launch grid is (k-tiles, j-tiles, i-chunks).  k
//     is fastest across threads, so every global access is a z-run.
//   - The fields the stencil reads (pmask_c, m.thl, dthl, and with the
//     correction c.thl, c.u, c.v) keep their window, halo included
//     ((TJ+2) x (TK+2)), in shared memory for a ring of consecutive planes,
//     copied ahead with cp.async; one __syncthreads() a plane.  The halo
//     elements are read from the wrapped and clamped positions (or from the
//     ring), so the window holds what the plain route's padded copy holds.
//   - The pointwise fields (the velocities, their masks, c.w) are read
//     once each at the thread's own point, straight from global memory.
//   - Threads outside the domain copy, but compute and store nothing, and
//     reach every barrier.
//
// Without thl (no ltempeq) only the velocities are masked: a flat
// elementwise kernel.
//
// chip_smoke.py phase 3 prints the register and spill report of the source
// it builds.

#include <cuda_runtime.h>

namespace {

// Tile of one block (TJ x TK threads), the planes in the ring and the
// least number of blocks the launcher aims for when it cuts i into chunks:
// the best of a sweep on the H100 at 128^3 and 512 x 512 x 128 float32
// (57.9% and 67.9% of the bound in a CUDA graph, against 51.5% and 48.1%
// with fused_vreman.cu's 8 x 32 tile, 5 planes and 528 blocks).  Many
// short chunks leave no half-empty last wave of blocks.
constexpr int TJ = 4, TK = 64;
constexpr int NT = TJ * TK;            // threads of a block
constexpr int WJ = TJ + 2, WK = TK + 2;
constexpr int PL = WJ * WK;            // elements of one window
constexpr int NSLOT = 4;               // planes in the ring
constexpr int AHEAD = NSLOT - 3;       // planes in flight beyond the stencil's
static_assert(AHEAD >= 1, "the ring needs a slot to copy into");
constexpr int NE = (PL + NT - 1) / NT; // window elements a thread copies
static_assert(NT <= 1024, "tile has more threads than a block can hold");
constexpr int MIN_BLOCKS = 5280;

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

// The arrays of one call (the header names them) and its sizes.
template <typename T>
struct Args {
  const T *du, *dv, *dw, *mu, *mv, *mw, *Mu, *Mv, *Mw;
  const T *mthl, *dthl, *cthl, *cu, *cv, *cw, *pmc, *vmean;
  const T *dzf_g, *dzhi, *dzfi5;
  T *du_o, *dv_o, *dw_o, *mu_o, *mv_o, *mw_o, *mthl_o, *dthl_o;
  T dxi5, dyi5;
  int nx, ny, nz;
};

// The masked u and v at cell offset o, and w at face offset ow.
template <typename T>
__device__ __forceinline__ void mask_uv(const Args<T>& a, long long o) {
  a.du_o[o] = a.du[o] * a.Mu[o];
  a.dv_o[o] = a.dv[o] * a.Mv[o];
  a.mu_o[o] = a.mu[o] * a.Mu[o];
  a.mv_o[o] = a.mv[o] * a.Mv[o];
}
template <typename T>
__device__ __forceinline__ void mask_w(const Args<T>& a, long long ow) {
  a.dw_o[ow] = a.dw[ow] * a.Mw[ow];
  a.mw_o[ow] = a.mw[ow] * a.Mw[ow];
}

// Without thl: one thread a cell, and a face of w each.
template <typename T>
__global__ void __launch_bounds__(NT)
fused_ibmnorm_uvw_kernel(const Args<T> a) {
  const long long nc = (long long)a.nx * a.ny * a.nz;
  const long long nw = (long long)a.nx * a.ny * (a.nz + 1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < nw; t += stride) {
    if (t < nc) mask_uv(a, t);
    mask_w(a, t);
  }
}

// Ring fields: pmask_c, m.thl, dthl, and with CORR c.thl, c.u, c.v.
template <bool CORR>
constexpr int ring_fields() { return CORR ? 6 : 3; }

template <typename T, bool CORR, bool RING>
__global__ void __launch_bounds__(NT)
fused_ibmnorm_kernel(const Args<T> a, int ci) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  constexpr int FS = NSLOT * PL;
  T* const rp = sm;              // pmask_c
  T* const rm = sm + FS;         // m.thl
  T* const rd = sm + 2 * FS;     // dthl
  T* const rt = sm + 3 * FS;     // c.thl  (CORR only, as the next two)
  T* const ru = sm + 4 * FS;     // c.u
  T* const rv = sm + 5 * FS;     // c.v

  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TK + tx;
  const int k0 = blockIdx.x * TK, j0 = blockIdx.y * TJ;
  const int i0 = blockIdx.z * ci;
  const int n = min(ci, nx - i0);      // planes this block computes
  const int k = k0 + tx, j = j0 + ty;
  const bool inside = (k < nz) && (j < ny);

  // plane strides of pmask_c and of the scalar fields
  const long long px = (long long)(ny + 2) * (nz + 2);
  const long long sx = (long long)(RING ? ny + 2 : ny) * nz;

  // What this thread copies of every plane: window elements e = tid,
  // tid + NT, ...; window (jj, kk) is ghosted (j0 + jj, k0 + kk), cell
  // (j0 + jj - 1, k0 + kk - 1).  In-plane offsets of pmask_c and of the
  // scalar fields (y wrapped unless RING, k clamped), or -1 outside.
  int g_p[NE], g_s[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    const int e = tid + q * NT;
    const int jj = e / WK, kk = e - jj * WK;
    const int jg = j0 + jj, kg = k0 + kk;
    const bool ok = (e < PL) && (jg <= ny + 1) && (kg <= nz + 1);
    const int js = RING ? jg
                        : (jg == 0 ? ny - 1 : (jg == ny + 1 ? 0 : jg - 1));
    const int ks = min(max(kg - 1, 0), nz - 1);
    g_p[q] = ok ? jg * (nz + 2) + kg : -1;
    g_s[q] = ok ? js * nz + ks : -1;
  }
  // Copy plane pl of this block's march (ghosted plane i0 + pl) of the
  // ring fields into slot pl % NSLOT, as one group; beyond the last plane
  // the group is empty, so that every step commits exactly one.
  auto load_plane = [&](int pl) {
    const int pg = i0 + pl;
    const int is = RING ? pg
                        : (pg == 0 ? nx - 1 : (pg == nx + 1 ? 0 : pg - 1));
    const long long op = (long long)pg * px;
    const long long os = (long long)is * sx;
    const int so = (pl % NSLOT) * PL;
    if (pl <= n + 1) {
#pragma unroll
      for (int q = 0; q < NE; ++q) {
        if (g_p[q] < 0) continue;
        const int e = tid + q * NT;
        cp_async<sizeof(T)>(rp + so + e, a.pmc + op + g_p[q]);
        cp_async<sizeof(T)>(rm + so + e, a.mthl + os + g_s[q]);
        cp_async<sizeof(T)>(rd + so + e, a.dthl + os + g_s[q]);
        if (CORR) {
          cp_async<sizeof(T)>(rt + so + e, a.cthl + os + g_s[q]);
          cp_async<sizeof(T)>(ru + so + e, a.cu + os + g_s[q]);
          cp_async<sizeof(T)>(rv + so + e, a.cv + os + g_s[q]);
        }
      }
    }
    cp_async_commit();
  };

  // step s (cell i0 + s) reads planes s, s+1, s+2 of the march
#pragma unroll
  for (int pl = 0; pl < 2 + AHEAD; ++pl) load_plane(pl);

  // metrics of this thread's k, once for the whole march
  T dzf_km = 0, dzf_k = 0, dzf_kp = 0;
  T dzhi_k = 0, dzhi_kp = 0, dzfi5_k = 0;
  if (CORR && inside) {
    dzf_km = a.dzf_g[k]; dzf_k = a.dzf_g[k + 1]; dzf_kp = a.dzf_g[k + 2];
    dzhi_k = a.dzhi[k]; dzhi_kp = a.dzhi[k + 1]; dzfi5_k = a.dzfi5[k];
  }
  const T vmean = *a.vmean;
  const int cc = (ty + 1) * WK + (tx + 1);   // this thread's window point

  for (int s = 0; s < n; ++s) {
    // planes up to s + 2 have landed, and every thread is done with the
    // slot that the next copy overwrites (plane s - 1, read at step s - 1)
    cp_async_wait_group<AHEAD - 1>();
    __syncthreads();
    load_plane(s + 2 + AHEAD);
    if (!inside) continue;

    const int i = i0 + s;
    const long long o = ((long long)i * ny + j) * nz + k;
    const long long ow = ((long long)i * ny + j) * (nz + 1) + k;
    mask_uv(a, o);
    mask_w(a, ow);
    if (k == nz - 1) mask_w(a, ow + 1);   // the top face

    // window offsets of planes i-1, i, i+1 (index di + 1)
    const int po[3] = {(s % NSLOT) * PL + cc, ((s + 1) % NSLOT) * PL + cc,
                       ((s + 2) % NSLOT) * PL + cc};
#define R(F, di, dj, dk) F[po[(di) + 1] + (dj) * WK + (dk)]

    // ---- solid_fill of m.thl and dthl (ibm.py solid_fill) ----
    const T mc = R(rp, 0, 0, 0);
    T thl_v, dthl_v;
    if (mc > T(0.5)) {
      thl_v = R(rm, 0, 0, 0);
      dthl_v = R(rd, 0, 0, 0);
    } else {
      const T pe = R(rp, 1, 0, 0), pw = R(rp, -1, 0, 0);
      const T pn = R(rp, 0, 1, 0), ps = R(rp, 0, -1, 0);
      const T pt = R(rp, 0, 0, 1), pb = R(rp, 0, 0, -1);
      const T cnt = pe + pw + pn + ps + pt + pb;
      const T tot_v = R(rm, 1, 0, 0) * pe + R(rm, -1, 0, 0) * pw
                      + R(rm, 0, 1, 0) * pn + R(rm, 0, -1, 0) * ps
                      + R(rm, 0, 0, 1) * pt + R(rm, 0, 0, -1) * pb;
      const T tot_r = R(rd, 1, 0, 0) * pe + R(rd, -1, 0, 0) * pw
                      + R(rd, 0, 1, 0) * pn + R(rd, 0, -1, 0) * ps
                      + R(rd, 0, 0, 1) * pt + R(rd, 0, 0, -1) * pb;
      // clamp(cnt, min=1), NaN kept, as torch.clamp does
      const T den = cnt < T(1) ? T(1) : cnt;
      const bool has = cnt > T(0);
      thl_v = has ? tot_v / den : vmean;
      dthl_v = has ? tot_r / den : T(0);
    }

    if (CORR) {
      // ---- advecc2nd_corr_liberal (ibm.py), times M.c ----
      const T vc = R(rt, 0, 0, 0);
      const T vv = vc + vc;
      const T fe = (T(1) - R(rp, 1, 0, 0)) * R(ru, 1, 0, 0)
                   * ((R(rt, 1, 0, 0) + vc) - vv) * a.dxi5;
      const T fw = (T(1) - R(rp, -1, 0, 0)) * R(ru, 0, 0, 0)
                   * ((R(rt, -1, 0, 0) + vc) - vv) * a.dxi5;
      const T fn = (T(1) - R(rp, 0, 1, 0)) * R(rv, 0, 1, 0)
                   * ((R(rt, 0, 1, 0) + vc) - vv) * a.dyi5;
      const T fs = (T(1) - R(rp, 0, -1, 0)) * R(rv, 0, 0, 0)
                   * ((R(rt, 0, -1, 0) + vc) - vv) * a.dyi5;
      const T ft = (T(1) - R(rp, 0, 0, 1)) * a.cw[ow + 1]
                   * ((R(rt, 0, 0, 1) * dzf_k + vc * dzf_kp)
                      - (vc * dzf_k + vc * dzf_kp))
                   * dzhi_kp * dzfi5_k;
      const T fb = (T(1) - R(rp, 0, 0, -1)) * a.cw[ow]
                   * ((R(rt, 0, 0, -1) * dzf_k + vc * dzf_km)
                      - (vc * dzf_k + vc * dzf_km))
                   * dzhi_k * dzfi5_k;
      const T corr = fe - fw + fn - fs + ft - fb;
      dthl_v = dthl_v + corr * mc;
    }
#undef R
    a.mthl_o[o] = thl_v;
    a.dthl_o[o] = dthl_v;
  }
}

// Shared memory of one block of fused_ibmnorm_kernel<T, CORR, RING>, which
// may exceed the default 48 KB (float64 with the correction): the limit is
// raised once per instantiation.  Returns the bytes, or 0 on failure.
template <typename T, bool CORR, bool RING>
size_t prepare() {
  static size_t bytes = 0;
  if (bytes == 0) {
    const size_t want = (size_t)ring_fields<CORR>() * NSLOT * PL * sizeof(T);
    if (cudaFuncSetAttribute(fused_ibmnorm_kernel<T, CORR, RING>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)want) != cudaSuccess)
      return 0;
    bytes = want;
  }
  return bytes;
}

template <typename T, bool CORR, bool RING>
int launch_thl(const Args<T>& a, void* stream) {
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const size_t smem = prepare<T, CORR, RING>();
  if (smem == 0) return (int)cudaGetLastError();
  const long long tiles = (long long)((nz + TK - 1) / TK)
                          * ((ny + TJ - 1) / TJ);
  // Halve the i-chunk until the grid has MIN_BLOCKS blocks; every chunk
  // re-reads two planes of the ring fields, so it is not cut below four.
  int ci = nx;
  while (ci > 4 && tiles * ((nx + ci - 1) / ci) < MIN_BLOCKS)
    ci = (ci + 1) / 2;
  const dim3 grid((nz + TK - 1) / TK, (ny + TJ - 1) / TJ,
                  (nx + ci - 1) / ci);
  if (grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 block(TK, TJ, 1);
  fused_ibmnorm_kernel<T, CORR, RING><<<grid, block, smem,
                                      (cudaStream_t)stream>>>(a, ci);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args<T>& a, int ring, void* stream) {
  if (a.nx < 1 || a.ny < 1 || a.nz < 1) return (int)cudaErrorInvalidValue;
  // in-plane offsets are held in 32 bits
  if ((long long)(a.ny + 2) * (a.nz + 2) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const bool thl = a.mthl != nullptr, corr = a.cthl != nullptr;
  if (!thl) {
    if (corr || ring) return (int)cudaErrorInvalidValue;
    const long long nw = (long long)a.nx * a.ny * (a.nz + 1);
    const long long blocks = (nw + NT - 1) / NT;
    const unsigned grid = (unsigned)(blocks < 8448 ? blocks : 8448);
    fused_ibmnorm_uvw_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (!a.dthl || !a.pmc || !a.vmean || !a.mthl_o || !a.dthl_o)
    return (int)cudaErrorInvalidValue;
  if (corr && (!a.cu || !a.cv || !a.cw || !a.dzf_g || !a.dzhi || !a.dzfi5))
    return (int)cudaErrorInvalidValue;
  if (corr)
    return ring ? launch_thl<T, true, true>(a, stream)
                : launch_thl<T, true, false>(a, stream);
  return ring ? launch_thl<T, false, true>(a, stream)
              : launch_thl<T, false, false>(a, stream);
}

template <typename T>
int entry(const void* du, const void* dv, const void* dw, const void* mu,
          const void* mv, const void* mw, const void* Mu, const void* Mv,
          const void* Mw, const void* mthl, const void* dthl,
          const void* cthl, const void* cu, const void* cv, const void* cw,
          const void* pmc, const void* vmean, const void* dzf_g,
          const void* dzhi, const void* dzfi5, void* du_o, void* dv_o,
          void* dw_o, void* mu_o, void* mv_o, void* mw_o, void* mthl_o,
          void* dthl_o, int nx, int ny, int nz, int ring, double dxi5,
          double dyi5, void* stream) {
  const Args<T> a{(const T*)du, (const T*)dv, (const T*)dw, (const T*)mu,
                  (const T*)mv, (const T*)mw, (const T*)Mu, (const T*)Mv,
                  (const T*)Mw, (const T*)mthl, (const T*)dthl,
                  (const T*)cthl, (const T*)cu, (const T*)cv, (const T*)cw,
                  (const T*)pmc, (const T*)vmean, (const T*)dzf_g,
                  (const T*)dzhi, (const T*)dzfi5, (T*)du_o, (T*)dv_o,
                  (T*)dw_o, (T*)mu_o, (T*)mv_o, (T*)mw_o, (T*)mthl_o,
                  (T*)dthl_o, (T)dxi5, (T)dyi5, nx, ny, nz};
  return dispatch<T>(a, ring, stream);
}

}  // namespace

// Blocks of one thl instantiation (without the ring; `corr` selects the
// correction) that fit on an SM at once, or minus the cudaError.
extern "C" int fused_ibmnorm_blocks_per_sm(int f64, int corr) {
  auto ask = [](auto kernel, size_t smem) {
    if (smem == 0) return -(int)cudaGetLastError();
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, NT, smem);
    return err == cudaSuccess ? blocks : -(int)err;
  };
  if (f64)
    return corr ? ask(fused_ibmnorm_kernel<double, true, false>,
                      prepare<double, true, false>())
                : ask(fused_ibmnorm_kernel<double, false, false>,
                      prepare<double, false, false>());
  return corr ? ask(fused_ibmnorm_kernel<float, true, false>,
                    prepare<float, true, false>())
              : ask(fused_ibmnorm_kernel<float, false, false>,
                    prepare<float, false, false>());
}

// m.thl null: the velocities alone (no thl pointer, no ring); m.thl set:
// the solid fill too, with dthl, pmask_c, thl_vmean and both thl outputs;
// c.thl set as well: the liberal correction, with c.u, c.v, c.w and the
// three metric vectors.  ring 1: the scalar fields carry the x/y ring.
extern "C" int fused_ibmnorm_f32(
    const void* du, const void* dv, const void* dw, const void* mu,
    const void* mv, const void* mw, const void* Mu, const void* Mv,
    const void* Mw, const void* mthl, const void* dthl, const void* cthl,
    const void* cu, const void* cv, const void* cw, const void* pmc,
    const void* vmean, const void* dzf_g, const void* dzhi,
    const void* dzfi5, void* du_o, void* dv_o, void* dw_o, void* mu_o,
    void* mv_o, void* mw_o, void* mthl_o, void* dthl_o, int nx, int ny,
    int nz, int ring, double dxi5, double dyi5, void* stream) {
  return entry<float>(du, dv, dw, mu, mv, mw, Mu, Mv, Mw, mthl, dthl, cthl,
                      cu, cv, cw, pmc, vmean, dzf_g, dzhi, dzfi5, du_o, dv_o,
                      dw_o, mu_o, mv_o, mw_o, mthl_o, dthl_o, nx, ny, nz,
                      ring, dxi5, dyi5, stream);
}

extern "C" int fused_ibmnorm_f64(
    const void* du, const void* dv, const void* dw, const void* mu,
    const void* mv, const void* mw, const void* Mu, const void* Mv,
    const void* Mw, const void* mthl, const void* dthl, const void* cthl,
    const void* cu, const void* cv, const void* cw, const void* pmc,
    const void* vmean, const void* dzf_g, const void* dzhi,
    const void* dzfi5, void* du_o, void* dv_o, void* dw_o, void* mu_o,
    void* mv_o, void* mw_o, void* mthl_o, void* dthl_o, int nx, int ny,
    int nz, int ring, double dxi5, double dyi5, void* stream) {
  return entry<double>(du, dv, dw, mu, mv, mw, Mu, Mv, Mw, mthl, dthl, cthl,
                       cu, cv, cw, pmc, vmean, dzf_g, dzhi, dzfi5, du_o,
                       dv_o, dw_o, mu_o, mv_o, mw_o, mthl_o, dthl_o, nx, ny,
                       nz, ring, dxi5, dyi5, stream);
}
