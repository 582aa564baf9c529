// Kappa advection and masked subgrid diffusion of the passive-scalar stack
// in one pass (modadvection.f90:316-421 advecc_kappa, modsubgrid.f90:540-623
// diffc with modibm.f90 diffc_corr folded in as a c mask): the tendency of
// every scalar of the stack.
//
// Replaces no TPU Pallas kernel: udales_tpu leaves the scalars to XLA's
// fusions.  It was added because the port's scalars leaf ran as ~140
// whole-stack torch operations a substep, on strided views of the
// kappa-ghosted stack, at about 1% of its memory bound on the H100 (7.49 ms
// a step at 128^3 float32 with 3 scalars against a bound of 0.083 ms for
// three substeps).  It computes exactly what
// udales_tpu_torch/ops/fused_scalars.py plain_scalars computes, with the
// same formulas in the same order:
//   advection  the limited flux (ops/advection.py limited_flux, _rlim) at
//              each face: the upwind value plus the limited correction
//              (times dx in x and dzfc in z, not in y), times the face
//              velocity; no flux through the floor (face 0); the tendency
//              ((Fx_l - Fx_r) dxi + (Fy_l - Fy_r) dyi) + (Fz_l - Fz_r) dzfci
//   diffusion  ops/subgrid.py diff_c of the stack's h=1 view with ekh, each
//              flux times the c mask of the cell across the face
//   tendency   advection + diffusion
// Each Python constant of the plain route (1e-10, 1/3, 2/3, 2, 0.5, the
// grid's spacings) is rounded to the field's type, as PyTorch's scalar
// operations round it; the limiter's min and clamps return a NaN operand as
// torch.minimum and torch.clamp do; a face velocity of 0 takes the
// negative branch, as torch.where(vel > 0, ...) does.  The source is
// compiled without FMA contraction (--fmad=false, ops/fused_scalars.py), so
// that every product and sum rounds as PyTorch's elementwise operations
// round it: on the card the kernel equals the plain route bit for bit.
//
// Inputs, C-contiguous with z fastest: the stack sv (nsv, nx+4, ny+4, nz+4)
// in the kappa layout (two ghost cells on each side of x, y and z), the h=1
// ghosted u, v, ekh and c mask (nx+2, ny+2, nz+2) and w (nx+2, ny+2, nz+1),
// and the vectors dzhci_g (nz+3), dzfc_g and dzfci_g (nz+4), dzf_g (nz+2),
// dzh2i (nz+1) and dzfi (nz).  Open x/y and the ranks of a split need
// nothing of their own: their planes and halos are in the ghosts already.
// The output dsv (nsv, nx, ny, nz) is a fresh array.
//
// What bounds it on the H100: bytes.  Per grid point it reads each scalar,
// u, v, w, ekh and the mask once and writes each scalar's tendency, 44
// bytes in float32 with 3 scalars; but the limiter costs a division and
// ~35 operations a face, so the arithmetic is close to the memory time and
// the design spends as few operations as it can:
//
//   - A block owns a (TJ x TK) window of (j, k) and marches along i over a
//     chunk of planes; the launch grid is (k-tiles, j-tiles, i-chunks).  k
//     is fastest across threads, so every global access is a z-run.
//   - Every scalar's window, with its two-cell halo ((TJ+4) x (TK+4)), and
//     ekh's and the mask's, with a one-cell halo, sit in shared memory for a
//     ring of consecutive planes, copied ahead with cp.async.  Each plane of
//     ekh and the mask is loaded once and serves every scalar: the loop over
//     the stack is inside the block.  u, v and w are read at the thread's
//     own faces straight from global memory, once for all the scalars.
//   - A launch takes a group of up to MAX_GROUP scalars, its size a template
//     parameter, so that the loops over the group unroll and the scalars'
//     arithmetic interleaves: the kernel is bound by latency more than by
//     instruction rate (a sweep on the H100 at 128^3: 22% of the bound with
//     the loop at run time, 26% with three blocks an SM, 30% unrolled).
//   - Each face flux is formed once.  The x flux through the face ahead of
//     the cell is kept for the next plane; a thread forms the y and z fluxes
//     through its cell's lower faces (and threads one row or column past the
//     domain form those of its last faces), a few threads those through the
//     tile's upper edges, and each cell reads its upper faces' from its
//     neighbours in shared memory.  Two __syncthreads() a plane: the ring's
//     and the fluxes'.
//   - The limiter's NaN tests are folded into one: its ratio is NaN exactly
//     when every term of the min and the clamps is, and the result is then
//     the NaN that torch.minimum returns.
//   - Threads outside the domain copy, but store nothing, and reach every
//     barrier.
//   - A deeper stack, or one too deep for a block's shared memory, is taken
//     in groups, one launch a group.
//
// chip_smoke.py phase 3 prints the register and spill report of the source
// it builds.

#include <cuda_runtime.h>

namespace {

// Tile of one block (TJ x TK threads), the planes in the ring, the blocks
// an SM should hold at once (which caps the registers at 80), the least
// number of blocks the launcher aims for when it cuts i into chunks, and
// the scalars a launch takes at most: the best of the sweep.
constexpr int TJ = 8, TK = 32;
constexpr int NT = TJ * TK;              // threads of a block
constexpr int WJ = TJ + 4, WK = TK + 4;  // a scalar's window
constexpr int PW = WJ * WK;
constexpr int EJ = TJ + 2, EK = TK + 2;  // the window of ekh and the mask
constexpr int PE = EJ * EK;
constexpr int NSLOT = 5;                 // planes in the ring
constexpr int AHEAD = NSLOT - 4;         // planes in flight beyond the use
static_assert(AHEAD >= 1, "the ring needs a slot to copy into");
constexpr int NEW = (PW + NT - 1) / NT;  // a window's elements a thread
constexpr int NEE = (PE + NT - 1) / NT;  // copies: a scalar's, ekh's
static_assert(NT <= 1024, "tile has more threads than a block can hold");
static_assert(TJ + TK <= NT, "too few threads for the tile's edge faces");
constexpr int MIN_RESIDENT = 3;
constexpr int MIN_BLOCKS = 1056;
constexpr int MIN_CHUNK = 8;
constexpr int MAX_GROUP = 4;
// shared memory of one block at most: the stack is cut into groups of
// scalars that fit, so that at least two blocks stay resident on an SM
constexpr size_t MAX_SMEM = 113 * 1024;

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

// The min and max of two values that are not NaN, as torch.minimum and
// torch.clamp take them on the card (-0 below +0).
__device__ __forceinline__ float lesser(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double lesser(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float greater(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double greater(double a, double b) {
  return fmax(a, b);
}

// The kappa scheme's limiter times d1 (advection.py _rlim):
//   phir = clamp(minimum(2 ri, clamp(1/3 + 2/3 ri, max=2)), min=0)
// 2 ri and 1/3 + 2/3 ri are NaN exactly when ri is, so where ri is not NaN
// no operand of the min and the clamps is, and where it is, torch.minimum
// returns its first operand, 2 ri, and the clamp keeps it.
template <typename T>
__device__ __forceinline__ T rlim(T d1, T d2) {
  const T ri = (d2 + T(1.0e-10)) / (d1 + T(1.0e-10));
  const T twice = T(2.0) * ri;
  const T lin = lesser(T(1.0 / 3.0) + T(2.0 / 3.0) * ri, T(2.0));
  T phir = greater(lesser(twice, lin), T(0.0));
  if (ri != ri) phir = twice;
  return (T(0.5) * phir) * d1;
}

// The limited flux through one face (advection.py limited_flux): cm1, c0,
// c1, c2 are the cells two and one before the face and one and two after
// it; with METRIC the differences are scaled by the metrics mm, m0, mp and
// the correction by width (x and z), without it neither (y).  Only the
// upwind side's values are formed, which is what torch.where keeps: a
// velocity of 0, or NaN, takes the side after the face.
template <typename T, bool METRIC>
__device__ __forceinline__ T kappa_flux(T cm1, T c0, T c1, T c2, T vel,
                                        T mm = T(0), T m0 = T(0),
                                        T mp = T(0), T width = T(0)) {
  const bool pos = vel > T(0);
  const T cf = pos ? c0 : c1;
  T d1 = cf - (pos ? cm1 : c2);          // d1p = c0 - cm1, d1m = c1 - c2
  T d2 = (pos ? c1 : c0) - cf;           // d2p = c1 - c0,  d2m = c0 - c1
  if (METRIC) {
    d1 = d1 * (pos ? mm : mp);
    d2 = d2 * m0;
  }
  T lim = rlim(d1, d2);
  if (METRIC) lim = width * lim;
  return (cf + lim) * vel;
}

// The arrays of one call (the header names them) and its sizes.
template <typename T>
struct Args {
  const T *sv, *u, *v, *w, *ekh, *mask;
  const T *dzhci, *dzfc, *dzfci, *dzf, *dzh2i, *dzfi;
  T* out;
  T dxi, dyi, dx, dx2i, dy2i;
  int nsv, nx, ny, nz;
};

// Shared memory of one block, in elements, per scalar and for all.  A
// scalar's: its ring of windows; the x flux kept for the next plane, the
// x term and the diffusion of the thread's cell; the y fluxes of the tile's
// TJ + 1 faces a column and the z fluxes of its TK + 1 faces a row.  For
// all: the ring of ekh's windows (and with MASK the mask's).
constexpr int PER_SCALAR = NSLOT * PW + 3 * NT + (TJ + 1) * TK
                           + TJ * (TK + 1);
template <bool MASK>
constexpr size_t smem_elems(int nsv) {
  return (size_t)nsv * PER_SCALAR + (MASK ? 2 : 1) * NSLOT * PE;
}

template <typename T, bool MASK, int NS>
__global__ void __launch_bounds__(NT, MIN_RESIDENT)
fused_scalars_kernel(const Args<T> a, int ci) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nsv = NS;
  T* const rs = reinterpret_cast<T*>(smem_raw);  // [nsv][NSLOT][PW]
  T* const keep = rs + (size_t)nsv * NSLOT * PW; // [nsv][NT]
  T* const xs = keep + nsv * NT;                 // [nsv][NT]
  T* const ds = xs + nsv * NT;                   // [nsv][NT]
  T* const fy = ds + nsv * NT;                   // [nsv][TJ + 1][TK]
  T* const fz = fy + nsv * (TJ + 1) * TK;        // [nsv][TJ][TK + 1]
  T* const re = fz + nsv * TJ * (TK + 1);        // [NSLOT][PE]
  T* const rm = re + NSLOT * PE;                 // [NSLOT][PE], MASK only

  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TK + tx;
  const int k0 = blockIdx.x * TK, j0 = blockIdx.y * TJ;
  const int i0 = blockIdx.z * ci;
  const int n = min(ci, nx - i0);      // planes this block computes
  const int k = k0 + tx, j = j0 + ty;
  const bool inside = (k < nz) && (j < ny);
  // forms the y and z fluxes through its cell's lower faces: the cells of
  // the domain and one row and one column past it (the domain's last faces)
  const bool fluxer = (k <= nz) && (j <= ny);
  // forms the y flux through the tile's upper edge (face j0 + TJ) at
  // column k0 + tid, or the z flux through face k0 + TK at row j0 + tid - TK
  const bool north = tid < TK && j0 + TJ <= ny && k0 + tid < nz;
  const bool top = tid >= TK && tid < TK + TJ && k0 + TK <= nz
                   && j0 + tid - TK < ny;

  // strides: a plane and a scalar of the stack, a plane of ekh and mask
  const long long sx = (long long)(ny + 4) * (nz + 4);
  const long long ss = (long long)(nx + 4) * sx;
  const long long ex = (long long)(ny + 2) * (nz + 2);

  // What this thread copies of every plane: window elements e = tid,
  // tid + NT, ...; a scalar's window (jj, kk) is its ghosted (j0 + jj,
  // k0 + kk), ekh's and the mask's likewise in theirs.  In-plane offsets,
  // or -1 outside the array.
  int g_s[NEW], g_e[NEE];
#pragma unroll
  for (int q = 0; q < NEW; ++q) {
    const int e = tid + q * NT;
    const int jj = e / WK, kk = e - jj * WK;
    const int jg = j0 + jj, kg = k0 + kk;
    g_s[q] = (e < PW && jg < ny + 4 && kg < nz + 4) ? jg * (nz + 4) + kg
                                                    : -1;
  }
#pragma unroll
  for (int q = 0; q < NEE; ++q) {
    const int e = tid + q * NT;
    const int jj = e / EK, kk = e - jj * EK;
    const int jg = j0 + jj, kg = k0 + kk;
    g_e[q] = (e < PE && jg < ny + 2 && kg < nz + 2) ? jg * (nz + 2) + kg
                                                    : -1;
  }
  // Copy plane pl of this block's march into slot pl % NSLOT, as one
  // group: the stack's ghosted plane i0 + pl (cell i0 - 2 + pl) and, where
  // a cell of the chunk reads them, ekh's and the mask's ghosted plane
  // i0 - 1 + pl; beyond the last plane the group is empty, so that every
  // step commits exactly one.
  auto load_plane = [&](int pl) {
    const int slot = pl % NSLOT;
    if (pl <= n + 3) {
      const T* src = a.sv + (long long)(i0 + pl) * sx;
      T* dst = rs + slot * PW + tid;
#pragma unroll
      for (int s = 0; s < nsv; ++s) {
#pragma unroll
        for (int q = 0; q < NEW; ++q)
          if (g_s[q] >= 0) cp_async<sizeof(T)>(dst + q * NT, src + g_s[q]);
        src += ss;
        dst += NSLOT * PW;
      }
      if (pl >= 1 && pl <= n + 2) {
        const long long o = (long long)(i0 - 1 + pl) * ex;
#pragma unroll
        for (int q = 0; q < NEE; ++q) {
          if (g_e[q] < 0) continue;
          const int e = slot * PE + tid + q * NT;
          cp_async<sizeof(T)>(re + e, a.ekh + o + g_e[q]);
          if (MASK) cp_async<sizeof(T)>(rm + e, a.mask + o + g_e[q]);
        }
      }
    }
    cp_async_commit();
  };

  // the prologue reads planes 0 .. 3, step s (cell i0 + s) planes s+1 ..
  // s+4 of the march
#pragma unroll
  for (int pl = 0; pl < 4 + AHEAD; ++pl) load_plane(pl);

  // metrics of this thread's k, once for the whole march: the z face k
  // (dzhci at the face below, at and above it, dzfc of the cell above it),
  // the cell's dzfci, and diff_c's vectors; those of a top-edge thread's
  // face k0 + TK
  T zm = 0, z0 = 0, zp = 0, zw = 0, dzfci_k = 0, dzf_km = 0, dzf_k = 0;
  T dzf_kp = 0, dzh2i_k = 0, dzh2i_kp = 0, dzfi_k = 0;
  T ezm = 0, ez0 = 0, ezp = 0, ezw = 0;
  if (fluxer) {
    zm = a.dzhci[k]; z0 = a.dzhci[k + 1]; zp = a.dzhci[k + 2];
    zw = a.dzfc[k + 2];
  }
  if (top) {
    ezm = a.dzhci[k0 + TK]; ez0 = a.dzhci[k0 + TK + 1];
    ezp = a.dzhci[k0 + TK + 2]; ezw = a.dzfc[k0 + TK + 2];
  }
  if (inside) {
    dzfci_k = a.dzfci[k + 2];
    dzf_km = a.dzf[k]; dzf_k = a.dzf[k + 1]; dzf_kp = a.dzf[k + 2];
    dzh2i_k = a.dzh2i[k]; dzh2i_kp = a.dzh2i[k + 1]; dzfi_k = a.dzfi[k];
  }
  const T dxi = a.dxi, dyi = a.dyi, dx = a.dx, dx2i = a.dx2i;
  const T dy2i = a.dy2i;
  const long long cells = (long long)nx * ny * nz;
  const int cs = (ty + 2) * WK + (tx + 2);   // this thread's window points
  const int ce = (ty + 1) * EK + (tx + 1);
  // an edge thread's first window point: the tile's row TJ - 2 at column
  // tid (north), or its row tid - TK at column TK - 2 (top)
  const int cn = north ? TJ * WK + tid + 2
                       : (tid - TK + 2) * WK + TK;
  const long long gx = (long long)(ny + 2) * (nz + 2);   // u, v plane
  const long long gwx = (long long)(ny + 2) * (nz + 1);  // w plane
  // h=1 ghosted offsets of the thread's cell in u and v, and in w
  const long long gc0 = ((long long)(i0 + 1) * (ny + 2) + (j + 1))
                        * (nz + 2) + (k + 1);
  const long long gw0 = ((long long)(i0 + 1) * (ny + 2) + (j + 1))
                        * (nz + 1) + k;
  // and of an edge thread's face: v at (j0 + TJ, k0 + tid), w at
  // (j0 + tid - TK, k0 + TK)
  const long long ge0 = north
      ? ((long long)(i0 + 1) * (ny + 2) + (j0 + TJ + 1)) * (nz + 2)
            + (k0 + tid + 1)
      : ((long long)(i0 + 1) * (ny + 2) + (j0 + tid - TK + 1)) * (nz + 1)
            + (k0 + TK);

  // the prologue: the x flux through face i0 of each scalar (cells
  // i0 - 2 .. i0 + 1, planes 0 .. 3)
  cp_async_wait_group<AHEAD>();
  __syncthreads();
  if (inside) {
    const T ul = a.u[gc0];
#pragma unroll
    for (int sc = 0; sc < nsv; ++sc) {
      const T* win = rs + sc * NSLOT * PW + cs;
      keep[sc * NT + tid] = kappa_flux<T, true>(
          win[0], win[PW], win[2 * PW], win[3 * PW], ul, dxi, dxi, dxi, dx);
    }
  }

  for (int s = 0; s < n; ++s) {
    // planes up to s + 4 have landed, and every thread is done with the
    // slot that the next copy overwrites (plane s, last read at step s - 1
    // or in the prologue)
    cp_async_wait_group<AHEAD - 1>();
    __syncthreads();
    load_plane(s + 4 + AHEAD);

    // window offsets of planes i - 1 .. i + 2 (index di + 1)
    const int p0 = ((s + 1) % NSLOT) * PW, p1 = ((s + 2) % NSLOT) * PW;
    const int p2 = ((s + 3) % NSLOT) * PW, p3 = ((s + 4) % NSLOT) * PW;

    // ---- the fluxes through the lower faces, the x term, the diffusion
    if (fluxer) {
      const long long gc = gc0 + s * gx, gw = gw0 + s * gwx;
      const T vs = a.v[gc], wb = a.w[gw];
      const T ur = inside ? a.u[gc + gx] : T(0);
      // ekh and the mask at the cell and its six neighbours
      const int e0 = ((s + 1) % NSLOT) * PE + ce;   // plane i - 1
      const int e1 = ((s + 2) % NSLOT) * PE + ce;   // plane i
      const int e2 = ((s + 3) % NSLOT) * PE + ce;   // plane i + 1
      T ek = 0, ek_e = 0, ek_w = 0, ek_n = 0, ek_s = 0, ek_t = 0, ek_b = 0;
      T m_e = 1, m_w = 1, m_n = 1, m_s = 1, m_t = 1, m_b = 1;
      if (inside) {
        ek = re[e1]; ek_e = re[e2]; ek_w = re[e0]; ek_n = re[e1 + EK];
        ek_s = re[e1 - EK]; ek_t = re[e1 + 1]; ek_b = re[e1 - 1];
        if (MASK) {
          m_e = rm[e2]; m_w = rm[e0]; m_n = rm[e1 + EK]; m_s = rm[e1 - EK];
          m_t = rm[e1 + 1]; m_b = rm[e1 - 1];
        }
      }
#pragma unroll
    for (int sc = 0; sc < nsv; ++sc) {
        const T* win = rs + sc * NSLOT * PW + cs;
        const T c = win[p1], c_s = win[p1 - WK], c_n = win[p1 + WK];
        const T c_b = win[p1 - 1], c_t = win[p1 + 1];
        fy[(sc * (TJ + 1) + ty) * TK + tx] = kappa_flux<T, false>(
            win[p1 - 2 * WK], c_s, c, c_n, vs);
        fz[(sc * TJ + ty) * (TK + 1) + tx] = k == 0
            ? T(0)
            : kappa_flux<T, true>(win[p1 - 2], c_b, c, c_t, wb, zm, z0, zp,
                                  zw);
        if (!inside) continue;
        const T c_w = win[p0], c_e = win[p2];
        // ---- kappa advection in x (advection.py adv_kappa) ----
        const T fxr = kappa_flux<T, true>(c_w, c, c_e, win[p3], ur, dxi, dxi,
                                          dxi, dx);
        T* const kept = keep + sc * NT + tid;
        xs[sc * NT + tid] = (*kept - fxr) * dxi;
        *kept = fxr;
        // ---- subgrid diffusion (subgrid.py diff_c), masked ----
        T xp = (ek_e + ek) * (c_e - c), xm = (ek + ek_w) * (c - c_w);
        T yp = (ek_n + ek) * (c_n - c), ym = (ek + ek_s) * (c - c_s);
        T tp = ((dzf_kp * ek + dzf_k * ek_t) * (c_t - c)) * dzh2i_kp;
        T tm = ((dzf_km * ek + dzf_k * ek_b) * (c - c_b)) * dzh2i_k;
        if (MASK) {
          xp = xp * m_e; xm = xm * m_w; yp = yp * m_n; ym = ym * m_s;
          tp = tp * m_t; tm = tm * m_b;
        }
        ds[sc * NT + tid] = T(0.5) * (((xp - xm) * dx2i + (yp - ym) * dy2i)
                                      + (tp - tm) * dzfi_k);
      }
    }
    // ---- the fluxes through the tile's upper edges ----
    if (north || top) {
      const T vel = (north ? a.v : a.w)[ge0 + s * (north ? gx : gwx)];
      const int step = north ? WK : 1;
#pragma unroll
    for (int sc = 0; sc < nsv; ++sc) {
        const T* win = rs + sc * NSLOT * PW + p1 + cn;
        if (north)
          fy[(sc * (TJ + 1) + TJ) * TK + tid] = kappa_flux<T, false>(
              win[0], win[step], win[2 * step], win[3 * step], vel);
        else
          fz[(sc * TJ + tid - TK) * (TK + 1) + TK] = kappa_flux<T, true>(
              win[0], win[step], win[2 * step], win[3 * step], vel, ezm, ez0,
              ezp, ezw);
      }
    }
    __syncthreads();

    // ---- the tendency: ((x + y) + z) advection, then the diffusion ----
    if (inside) {
      const long long o = ((long long)(i0 + s) * ny + j) * nz + k;
#pragma unroll
    for (int sc = 0; sc < nsv; ++sc) {
        const T* fys = fy + (sc * (TJ + 1) + ty) * TK + tx;
        const T* fzs = fz + (sc * TJ + ty) * (TK + 1) + tx;
        const T advc = (xs[sc * NT + tid] + (fys[0] - fys[TK]) * dyi)
                       + (fzs[0] - fzs[1]) * dzfci_k;
        a.out[sc * cells + o] = advc + ds[sc * NT + tid];
      }
    }
  }
}

// Shared memory of one launch of nsv scalars, after raising the kernel's
// limit (once per instantiation) to MAX_SMEM; 0 on failure.
template <typename T, bool MASK, int NS>
size_t prepare() {
  static bool raised = false;
  if (!raised) {
    if (cudaFuncSetAttribute(fused_scalars_kernel<T, MASK, NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)MAX_SMEM) != cudaSuccess)
      return 0;
    raised = true;
  }
  return smem_elems<MASK>(NS) * sizeof(T);
}

template <typename T, bool MASK, int NS>
int launch_group(const Args<T>& a, dim3 grid, dim3 block, int ci,
                 void* stream) {
  const size_t smem = prepare<T, MASK, NS>();
  if (smem == 0) return (int)cudaGetLastError();
  fused_scalars_kernel<T, MASK, NS><<<grid, block, smem,
                                      (cudaStream_t)stream>>>(a, ci);
  return (int)cudaGetLastError();
}

// The scalars a launch takes at most: as many as fit in MAX_SMEM.
template <typename T, bool MASK>
int group_size() {
  int g = 1;
  while (g < MAX_GROUP && smem_elems<MASK>(g + 1) * sizeof(T) <= MAX_SMEM)
    ++g;
  return g;
}

template <typename T, bool MASK>
int launch(Args<T> a, void* stream) {
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const long long tiles = (long long)((nz + TK - 1) / TK)
                          * ((ny + TJ - 1) / TJ);
  // Halve the i-chunk until the grid has MIN_BLOCKS blocks; every chunk
  // re-reads four planes of the stack, so it is not cut below MIN_CHUNK.
  int ci = nx;
  while (ci > MIN_CHUNK && tiles * ((nx + ci - 1) / ci) < MIN_BLOCKS)
    ci = (ci + 1) / 2;
  const dim3 grid((nz + TK - 1) / TK, (ny + TJ - 1) / TJ,
                  (nx + ci - 1) / ci);
  if (grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 block(TK, TJ, 1);
  const int most = group_size<T, MASK>();
  const int nsv = a.nsv;
  const long long sstride = (long long)(nx + 4) * (ny + 4) * (nz + 4);
  const long long ostride = (long long)nx * ny * nz;
  for (int s0 = 0; s0 < nsv; s0 += most) {
    Args<T> part = a;
    part.nsv = nsv - s0 < most ? nsv - s0 : most;
    part.sv = a.sv + s0 * sstride;
    part.out = a.out + s0 * ostride;
    const int err =
        part.nsv == 1 ? launch_group<T, MASK, 1>(part, grid, block, ci, stream)
        : part.nsv == 2 ? launch_group<T, MASK, 2>(part, grid, block, ci,
                                                   stream)
        : part.nsv == 3 ? launch_group<T, MASK, 3>(part, grid, block, ci,
                                                   stream)
                        : launch_group<T, MASK, 4>(part, grid, block, ci,
                                                   stream);
    if (err != (int)cudaSuccess) return err;
  }
  return (int)cudaSuccess;
}

template <typename T>
int entry(const void* sv, const void* u, const void* v, const void* w,
          const void* ekh, const void* mask, const void* dzhci,
          const void* dzfc, const void* dzfci, const void* dzf,
          const void* dzh2i, const void* dzfi, void* out, int nsv, int nx,
          int ny, int nz, double dxi, double dyi, double dx, double dx2i,
          double dy2i, void* stream) {
  if (nsv < 1 || nx < 1 || ny < 1 || nz < 1)
    return (int)cudaErrorInvalidValue;
  // in-plane offsets are held in 32 bits
  if ((long long)(ny + 4) * (nz + 4) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (!sv || !u || !v || !w || !ekh || !dzhci || !dzfc || !dzfci || !dzf
      || !dzh2i || !dzfi || !out)
    return (int)cudaErrorInvalidValue;
  const Args<T> a{(const T*)sv, (const T*)u, (const T*)v, (const T*)w,
                  (const T*)ekh, (const T*)mask, (const T*)dzhci,
                  (const T*)dzfc, (const T*)dzfci, (const T*)dzf,
                  (const T*)dzh2i, (const T*)dzfi, (T*)out, (T)dxi, (T)dyi,
                  (T)dx, (T)dx2i, (T)dy2i, nsv, nx, ny, nz};
  return mask ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
}

}  // namespace

// Blocks of one instantiation (`masked` selects the c mask) that fit on an
// SM at once with the stack of three scalars, or minus the cudaError.
extern "C" int fused_scalars_blocks_per_sm(int f64, int masked) {
  auto ask = [](auto kernel, size_t smem) {
    if (smem == 0) return -(int)cudaGetLastError();
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, NT, smem);
    return err == cudaSuccess ? blocks : -(int)err;
  };
  if (f64)
    return masked ? ask(fused_scalars_kernel<double, true, 3>,
                        prepare<double, true, 3>())
                  : ask(fused_scalars_kernel<double, false, 3>,
                        prepare<double, false, 3>());
  return masked ? ask(fused_scalars_kernel<float, true, 3>,
                      prepare<float, true, 3>())
                : ask(fused_scalars_kernel<float, false, 3>,
                      prepare<float, false, 3>());
}

// mask null: the unmasked diffusion (no IBM).
extern "C" int fused_scalars_f32(
    const void* sv, const void* u, const void* v, const void* w,
    const void* ekh, const void* mask, const void* dzhci, const void* dzfc,
    const void* dzfci, const void* dzf, const void* dzh2i, const void* dzfi,
    void* out, int nsv, int nx, int ny, int nz, double dxi, double dyi,
    double dx, double dx2i, double dy2i, void* stream) {
  return entry<float>(sv, u, v, w, ekh, mask, dzhci, dzfc, dzfci, dzf, dzh2i,
                      dzfi, out, nsv, nx, ny, nz, dxi, dyi, dx, dx2i, dy2i,
                      stream);
}

extern "C" int fused_scalars_f64(
    const void* sv, const void* u, const void* v, const void* w,
    const void* ekh, const void* mask, const void* dzhci, const void* dzfc,
    const void* dzfci, const void* dzf, const void* dzh2i, const void* dzfi,
    void* out, int nsv, int nx, int ny, int nz, double dxi, double dyi,
    double dx, double dx2i, double dy2i, void* stream) {
  return entry<double>(sv, u, v, w, ekh, mask, dzhci, dzfc, dzfci, dzf,
                       dzh2i, dzfi, out, nsv, nx, ny, nz, dxi, dyi, dx, dx2i,
                       dy2i, stream);
}
