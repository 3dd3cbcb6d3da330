// The temporal-blocked tile shared by the whole-grid sweep kernel (B1) and
// the multigrid smoother's route for large levels (B3), both in sor.cu, the
// tiled sweep kernel (B4, sor_tiled.cu), the extended-block sweep kernel
// (B6, sor_ext.cu) and, over colour-compacted arrays in device memory, the
// compressed sweep kernel (B5, sor_compressed.cu).
//
// A block sweeps one tile of the array it is given: it loads delta for its
// TI x TJ centre and a halo of `halo` cells on each side into dynamic shared
// memory (cells outside the array load as 0), runs 2 ns half-sweeps there
// with a __syncthreads() between two, and writes back the cells of its
// centre that lie in the write window.  Stale values at the tile's edge
// travel one cell per half-sweep, so with halo >= 2 ns the centre equals the
// same sweeps over the whole array, and the tiles of one launch are
// independent.
//
// Array cell (a, b) is global padded cell (off_i + a, off_j + b) of an
// ni x nj padded grid: interior mask, parity and self_coef come from the
// global index, so an array cut out of a larger grid (B6's extended block of
// one shard) sweeps exactly as the grid would.  B1, B3 and B4 pass the grid
// itself (offset 0).
//
// The layout, chosen because the first version of this tile spent its time
// issuing instructions, not moving bytes (PERF.md):
//   - Shared memory holds delta alone, compacted by colour: colour c of the
//     (TI + 2H) x (TJ + 2H) tile is an array of (TI + 2H) x (TJ / 2 + H)
//     floats, cell (r, 2k + t) at [r][k] in the array of its colour.  A
//     red cell's four neighbours are then black[r -/+ 1][k] and
//     black[r][k + s - 1], black[r][k + s] (s its column's offset in the
//     pair), contiguous across a warp.
//   - Thread (k, y) owns the pair of cells (r, 2k), (r, 2k + 1), one of
//     each colour, in rows r = y, y + RS, y + 2 RS, ... (RS = blockDim.y,
//     even, so one colour offset q serves all its rows): each half-sweep it
//     updates one cell of each of its pairs.  Ownership is fixed for the
//     chunk, so rhs of its cells is loaded once into registers (when the
//     rows per thread, M, are a compile-time constant), and its cells are
//     written by it alone.
//   - Per half-sweep only the cells that can still reach the centre are
//     updated: after half-sweep h the cells within 2 ns - 1 - h of the
//     centre hold what a sweep of the full tile holds (by induction: such
//     a cell reads itself and neighbours within 2 ns - h), so the box of
//     half-sweep h is the centre widened by 2 ns - 1 - h, and the centre's
//     bits equal the full tile's.  It never reaches the tile's outer ring.
//   - Tiles whose first box lies inside global rows and columns
//     [2, n - 3] take a path without masks (self_coef is the same 0 for all
//     its cells); the others test each cell's global index as before.
//   - The main paths' tiles each have a kernel compiled for their shape
//     (kHotShapes below); any other tile runs the same body with its shape
//     read at run time.
//   - The arrays in device memory are full grids (B1, B3, B4, B6) or, for
//     B5, the grid's red and black cells in two half-width arrays
//     (TileChunk); a template parameter picks the load and store stages,
//     and each layout has its own kernel for every row of kHotShapes.
// The arithmetic is nsp_sor.cuh's rb_update, in the same order and
// rounding; self_coef is formed with the same operations.
//
// On an H100 (tile_bench.py, PERF.md) a chunk of 8 sweeps at 2050^2
// takes ~83 us against the first tile's 213 us; about a quarter of it is
// loading delta and storing the centre.  Delta held in registers as well,
// delta loaded by cp.async, and 128-wide or 128-tall tiles each ran slower
// and are left out.  A 258^2 grid is 25 tiles of 64 x 64, a fifth of the
// card: 64 sweeps take 0.129 ms there and 0.068 ms in 81 tiles of 32 x 32
// (same halo), which lose from 1026^2 up (0.31 against 0.26 ms) to their
// 2.24 updates per written cell; two sweeps of a 2050^2 multigrid level
// take 0.034 ms in 32 x 64 tiles with a 4-deep halo (0.035 in 64 x 64).
#pragma once

#include <cstddef>
#include <cstdint>
#include <utility>

#include "nsp_sor.cuh"

namespace nsp {

struct TileDomain {
  int rows, cols;      // the array swept, row-major
  int off_i, off_j;    // global padded index of its cell (0, 0)
  int ni, nj;          // the padded global grid
  int w_lo_i, w_hi_i;  // rows [w_lo_i, w_hi_i) of the array are written
  int w_lo_j, w_hi_j;  // columns [w_lo_j, w_hi_j)
};

// One chunk: ns <= halo / 2 sweeps of every tile, src -> dst (both of the
// domain's shape).  zero_src: delta = 0 on entry, src is not read.
// In the colour-compacted layout (B5) the domain is a whole grid (offset 0,
// cols even, written everywhere) held as two rows x cols / 2 arrays per
// field: src, dst and rhs hold its red cells, src1, dst1 and rhs1 its black
// ones, red[i][k] = d[i][2k + (i & 1)], black[i][k] = d[i][2k + 1 - (i & 1)]
// (the JAX package's _compress_colors).  Since a tile's first column is
// even, the pair of cells (a, 2k), (a, 2k + 1) that a thread owns is
// red[a][k] and black[a][k], whatever the row's parity.
// A batch of independent grids of one shape (an ensemble's members) is one
// launch: member z's arrays start member_stride floats after member z - 1's,
// and the blocks of member z have blockIdx.z = z.
struct TileChunk {
  const float* src;
  float* dst;
  const float* rhs;
  TileDomain dom;
  int ti, tj;  // the written centre of a tile (tj even)
  int halo;    // H: cells of halo on each side (even)
  int ns;      // sweeps of this chunk
  int zero_src;
  float one_minus_omega, coef, dx2_inv, dy2_inv;
  const float* src1 = nullptr;  // the black arrays of the compacted layout
  float* dst1 = nullptr;
  const float* rhs1 = nullptr;
  int batch = 1;             // members, on blockIdx.z
  size_t member_stride = 0;  // floats from one member's arrays to the next
};

// At most this many threads per block of a tile whose shape is read at run
// time.
constexpr int kTileMaxThreads = 576;
// The tiles of the main paths each have a kernel compiled for their shape,
// so that the shared-memory offsets are immediates (a run-time shape takes
// three times the registers): a ti x tj centre with a halo of `halo` cells,
// rs rows between a thread's rows (even), m rows per thread (rs m >= ti +
// 2 halo), min_blocks blocks per SM asked of the compiler.  tj / 2 + halo
// pairs per row times rs is the block's threads.
struct HotShape {
  int ti, tj, halo, rs, m, min_blocks;
};
constexpr HotShape kHotShapes[] = {
    {64, 64, 16, 12, 8, 2},  // B4 at K = 8, B6 at ns = 8, B1 on large grids
    {32, 64, 4, 10, 4, 2},   // B3: the two sweeps of a multigrid level
    {32, 32, 16, 16, 4, 1},  // B1 on small grids
};
constexpr int kHotCount = sizeof(kHotShapes) / sizeof(kHotShapes[0]);
// Any other tile: 16 rows per thread with rhs in registers where that
// takes at most kTileMaxThreads threads, else rhs from device memory.
constexpr int kRegRows = 16;

constexpr int hot_pairs(int i) {
  return kHotShapes[i].tj / 2 + kHotShapes[i].halo;
}
constexpr bool hot_shapes_valid() {
  for (int i = 0; i < kHotCount; ++i) {
    const HotShape s = kHotShapes[i];
    if (s.ti < 1 || s.tj < 2 || (s.tj & 1) || (s.halo & 1) || (s.rs & 1) ||
        s.rs * s.m < s.ti + 2 * s.halo || hot_pairs(i) * s.rs > 1024) {
      return false;
    }
  }
  return true;
}
static_assert(hot_shapes_valid(), "a tile of kHotShapes does not fit a block");

// How a chunk's tile maps onto a block.
struct TileGeometry {
  int er, pc;   // shared tile rows (ti + 2 halo), cell pairs per row
  int rs;       // blockDim.y: rows between two rows of one thread (even)
  int m;        // rows per thread, compile-time; 0: any, rhs not in
                // registers but read from device memory at each update
  int hot;      // index in kHotShapes of the kernel compiled for this
                // shape, -1: the shape is read at run time
  size_t smem;  // dynamic shared memory, bytes
};

inline TileGeometry tile_geometry(int ti, int tj, int halo) {
  TileGeometry g{};
  g.er = ti + 2 * halo;
  g.pc = (tj + 2 * halo) / 2;
  g.smem = sizeof(float) * static_cast<size_t>(g.er) * 2 * g.pc;
  g.hot = -1;
  for (int i = 0; i < kHotCount; ++i) {
    const HotShape s = kHotShapes[i];
    if (ti == s.ti && tj == s.tj && halo == s.halo) {
      g.rs = s.rs;
      g.m = s.m;
      g.hot = i;
      return g;
    }
  }
  g.rs = ((g.er + kRegRows - 1) / kRegRows + 1) & ~1;
  if (g.pc * g.rs <= kTileMaxThreads) {
    g.m = kRegRows;
    return g;
  }
  g.m = 0;
  g.rs = (kTileMaxThreads / g.pc) & ~1;
  if (g.rs < 2) g.rs = 2;
  if (g.rs > g.er + (g.er & 1)) g.rs = g.er + (g.er & 1);
  return g;
}

namespace tile_detail {

// Cells (a, b) and (a, b + 1) of a row-major rows x cols array, 0 outside
// it; one 8-byte access where both lie inside and `vec` holds (even cols,
// even b, 8-byte aligned base).
__device__ __forceinline__ void load_pair(const float* __restrict__ p,
                                          int rows, int cols, int a, int b,
                                          bool vec, float& x0, float& x1) {
  x0 = 0.0f;
  x1 = 0.0f;
  if (a < 0 || a >= rows) return;
  const float* row = p + static_cast<size_t>(a) * cols;
  if (vec && b >= 0 && b + 1 < cols) {
    const float2 v = *reinterpret_cast<const float2*>(row + b);
    x0 = v.x;
    x1 = v.y;
    return;
  }
  if (b >= 0 && b < cols) x0 = row[b];
  if (b + 1 >= 0 && b + 1 < cols) x1 = row[b + 1];
}

__device__ __forceinline__ bool vec_ok(const void* p, int cols, int b0) {
  return ((cols | b0) & 1) == 0 &&
         (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

// What a thread knows of its block for the chunk.
struct Block {
  int k, ty, rs, pc, er;  // its pair column and first row; the geometry
  int a0, b0;             // array cell of shared (0, 0)
  int i0, j0;             // its global index
  int q;                  // colour of column 2k in the thread's rows
  float sc0;              // self_coef of a cell off the boundary rows/cols
};

// Half-sweep h (of colour P) over the box of cells that can still reach
// the centre: own is the colour-P array, oth the other; rhs_p the thread's
// rhs of colour P per row (M > 0).
template <int M, int P, bool kMasked, bool kCompact>
__device__ __forceinline__ void half_sweep(const TileChunk& t, const Block& k,
                                           float* own, const float* oth,
                                           const float (&rhs_p)[M > 0 ? M : 1],
                                           int h) {
  const int s = k.q ^ P;  // the colour-P cell of pair k is column 2k + s
  const int c = 2 * k.k + s;
  const int span = 2 * t.ns - 1 - h;
  const int lo = t.halo - span;  // first row and column of the box
  if (static_cast<unsigned>(c - lo) >=
      static_cast<unsigned>(t.tj + 2 * span)) {
    return;
  }
  float sc_col = 0.0f;
  if constexpr (kMasked) {
    const int j = k.j0 + c;
    if (j < 1 || j > t.dom.nj - 2) return;
    sc_col = mul(static_cast<float>((j == 1) + (j == t.dom.nj - 2)),
                 t.dy2_inv);
  }
  const unsigned box_rows = static_cast<unsigned>(t.ti + 2 * span);
  const int count = M > 0 ? M : (k.er - k.ty + k.rs - 1) / k.rs;
#pragma unroll
  for (int m = 0; m < count; ++m) {
    const int r = k.ty + k.rs * m;
    if (static_cast<unsigned>(r - lo) >= box_rows) continue;
    float sc = k.sc0;
    if constexpr (kMasked) {
      const int i = k.i0 + r;
      if (i < 1 || i > t.dom.ni - 2) continue;
      sc = add(mul(static_cast<float>((i == 1) + (i == t.dom.ni - 2)),
                   t.dx2_inv),
               sc_col);
    }
    float rv;
    if constexpr (M > 0) {
      rv = rhs_p[m];
    } else if constexpr (kCompact) {
      const int a = k.a0 + r, kk = (k.b0 >> 1) + k.k, half = t.dom.cols >> 1;
      rv = (a >= 0 && a < t.dom.rows && kk >= 0 && kk < half)
               ? (P ? t.rhs1 : t.rhs)[static_cast<size_t>(a) * half + kk]
               : 0.0f;
    } else {
      const int a = k.a0 + r, b = k.b0 + c;
      rv = (a >= 0 && a < t.dom.rows && b >= 0 && b < t.dom.cols)
               ? t.rhs[static_cast<size_t>(a) * t.dom.cols + b]
               : 0.0f;
    }
    const int f = r * k.pc + k.k;
    const float dc = own[f];
    const float nb =
        add(add(mul(add(oth[f - k.pc], oth[f + k.pc]), t.dx2_inv),
                mul(add(oth[f + s - 1], oth[f + s]), t.dy2_inv)),
            mul(dc, sc));
    own[f] = add(mul(t.one_minus_omega, dc), mul(t.coef, sub(nb, rv)));
  }
}

template <int M, bool kMasked, bool kCompact>
__device__ __forceinline__ void sweeps(const TileChunk& t, const Block& k,
                                       float* col0, float* col1,
                                       const float (&rhs0)[M > 0 ? M : 1],
                                       const float (&rhs1)[M > 0 ? M : 1]) {
  for (int h = 0; h < 2 * t.ns; h += 2) {
    half_sweep<M, 0, kMasked, kCompact>(t, k, col0, col1, rhs0, h);
    __syncthreads();
    half_sweep<M, 1, kMasked, kCompact>(t, k, col1, col0, rhs1, h + 1);
    // No barrier after the last: each thread writes back its own cells.
    if (h + 2 < 2 * t.ns) __syncthreads();
  }
}

}  // namespace tile_detail

namespace {

// One chunk; block (blockIdx.x, blockIdx.y) takes the tile of columns
// blockIdx.x * tj and rows blockIdx.y * ti; blockDim = (pc, rs).  HOT >= 0:
// the tile kHotShapes[HOT], its shape known at compile time (M its rows per
// thread); HOT < 0: the shape comes with the chunk.  kCompact: the arrays
// in device memory are colour-compacted (TileChunk); only the loads and
// the stores differ.
template <int M, int HOT, bool kCompact>
__global__ void __launch_bounds__(
    HOT >= 0 ? hot_pairs(HOT >= 0 ? HOT : 0) *
                   kHotShapes[HOT >= 0 ? HOT : 0].rs
             : kTileMaxThreads,
    HOT >= 0 ? kHotShapes[HOT >= 0 ? HOT : 0].min_blocks : 1)
    tile_chunk(const TileChunk chunk) {
  using namespace tile_detail;
  extern __shared__ float smem[];
  constexpr bool kHot = HOT >= 0;
  constexpr HotShape kShape = kHotShapes[kHot ? HOT : 0];
  TileChunk t = chunk;
  const size_t member = static_cast<size_t>(blockIdx.z) * t.member_stride;
  t.src += member;
  t.dst += member;
  t.rhs += member;
  if constexpr (kCompact) {
    t.src1 += member;
    t.dst1 += member;
    t.rhs1 += member;
  }
  if constexpr (kHot) {
    t.ti = kShape.ti;
    t.tj = kShape.tj;
    t.halo = kShape.halo;
  }
  Block k;
  k.k = static_cast<int>(threadIdx.x);
  k.ty = static_cast<int>(threadIdx.y);
  k.rs = kHot ? kShape.rs : static_cast<int>(blockDim.y);
  k.pc = kHot ? kShape.tj / 2 + kShape.halo : static_cast<int>(blockDim.x);
  k.er = t.ti + 2 * t.halo;
  k.a0 = static_cast<int>(blockIdx.y) * t.ti - t.halo;
  k.b0 = static_cast<int>(blockIdx.x) * t.tj - t.halo;
  k.i0 = k.a0 + t.dom.off_i;
  k.j0 = k.b0 + t.dom.off_j;
  k.q = (k.i0 + k.ty + k.j0) & 1;
  k.sc0 = add(mul(0.0f, t.dx2_inv), mul(0.0f, t.dy2_inv));
  float* col0 = smem;
  float* col1 = smem + static_cast<size_t>(k.er) * k.pc;
  const int count = M > 0 ? M : (k.er - k.ty + k.rs - 1) / k.rs;
  const int b = k.b0 + 2 * k.k;

  // Load delta into the colour arrays and rhs into registers.
  float rhs0[M > 0 ? M : 1], rhs1[M > 0 ? M : 1];
  if constexpr (kCompact) {
    // Pair k is red[a][kk] and black[a][kk]: one coalesced 4-byte load per
    // colour, no select.
    const int half = t.dom.cols >> 1, kk = b >> 1;
#pragma unroll
    for (int m = 0; m < count; ++m) {
      const int r = k.ty + k.rs * m;
      if (r >= k.er) continue;
      const int a = k.a0 + r;
      const bool in = a >= 0 && a < t.dom.rows && kk >= 0 && kk < half;
      const size_t o = static_cast<size_t>(a) * half + kk;
      const int f = r * k.pc + k.k;
      col0[f] = in && !t.zero_src ? t.src[o] : 0.0f;
      col1[f] = in && !t.zero_src ? t.src1[o] : 0.0f;
      if constexpr (M > 0) {
        rhs0[m] = in ? t.rhs[o] : 0.0f;
        rhs1[m] = in ? t.rhs1[o] : 0.0f;
      }
    }
  } else {
    const bool vec_src = vec_ok(t.src, t.dom.cols, k.b0);
    const bool vec_rhs = vec_ok(t.rhs, t.dom.cols, k.b0);
#pragma unroll
    for (int m = 0; m < count; ++m) {
      const int r = k.ty + k.rs * m;
      if (r >= k.er) continue;
      float d0 = 0.0f, d1 = 0.0f;
      if (!t.zero_src) {
        load_pair(t.src, t.dom.rows, t.dom.cols, k.a0 + r, b, vec_src, d0,
                  d1);
      }
      if constexpr (M > 0) {
        float x0, x1;
        load_pair(t.rhs, t.dom.rows, t.dom.cols, k.a0 + r, b, vec_rhs, x0,
                  x1);
        rhs0[m] = k.q ? x1 : x0;
        rhs1[m] = k.q ? x0 : x1;
      }
      const int f = r * k.pc + k.k;
      col0[f] = k.q ? d1 : d0;
      col1[f] = k.q ? d0 : d1;
    }
  }
  __syncthreads();

  const int span0 = 2 * t.ns - 1;
  const int lo = t.halo - span0;
  const bool inside = k.i0 + lo >= 2 &&
                      k.i0 + lo + t.ti - 1 + 2 * span0 <= t.dom.ni - 3 &&
                      k.j0 + lo >= 2 &&
                      k.j0 + lo + t.tj - 1 + 2 * span0 <= t.dom.nj - 3;
  if (inside) {
    sweeps<M, false, kCompact>(t, k, col0, col1, rhs0, rhs1);
  } else {
    sweeps<M, true, kCompact>(t, k, col0, col1, rhs0, rhs1);
  }

  // Write back this thread's cells of the centre that lie in the window.
  const int c0 = 2 * k.k;
  if (c0 < t.halo || c0 >= t.halo + t.tj) return;
  const bool in0 = b >= t.dom.w_lo_j && b < t.dom.w_hi_j;
  const bool in1 = b + 1 >= t.dom.w_lo_j && b + 1 < t.dom.w_hi_j;
  const bool vec_dst = vec_ok(t.dst, t.dom.cols, k.b0) && in0 && in1;
#pragma unroll
  for (int m = 0; m < count; ++m) {
    const int r = k.ty + k.rs * m;
    if (r < t.halo || r >= t.halo + t.ti) continue;
    const int a = k.a0 + r;
    if (a < t.dom.w_lo_i || a >= t.dom.w_hi_i) continue;
    const int f = r * k.pc + k.k;
    if constexpr (kCompact) {
      // The window is the whole grid and cols is even: both cells of the
      // pair or neither lie in it.
      if (in0 && in1) {
        const size_t o =
            static_cast<size_t>(a) * (t.dom.cols >> 1) + (b >> 1);
        t.dst[o] = col0[f];
        t.dst1[o] = col1[f];
      }
      continue;
    }
    const float v0 = k.q ? col1[f] : col0[f];
    const float v1 = k.q ? col0[f] : col1[f];
    float* row = t.dst + static_cast<size_t>(a) * t.dom.cols;
    if (vec_dst) {
      *reinterpret_cast<float2*>(row + b) = make_float2(v0, v1);
    } else {
      if (in0) row[b] = v0;
      if (in1) row[b + 1] = v1;
    }
  }
}

// Every row of kHotShapes is compiled for the layout.
template <bool kCompact, int... I>
const void* hot_kernel(int i, std::integer_sequence<int, I...>) {
  const void* const fns[] = {reinterpret_cast<const void*>(
      tile_chunk<kHotShapes[I].m, I, kCompact>)...};
  return fns[i];
}

// Dynamic shared memory a kernel may use without asking for more.
constexpr size_t kDefaultSharedBytes = 48 * 1024;

// The kernel for a tile of geometry g in the layout, allowed g.smem of
// shared memory.
template <bool kCompact = false>
cudaError_t tile_kernel(const TileGeometry& g, const void** fn) {
  *fn = g.hot >= 0 ? hot_kernel<kCompact>(
                         g.hot, std::make_integer_sequence<int, kHotCount>{})
        : g.m > 0
            ? reinterpret_cast<const void*>(tile_chunk<kRegRows, -1, kCompact>)
            : reinterpret_cast<const void*>(tile_chunk<0, -1, kCompact>);
  if (g.smem <= kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(g.smem));
}

// Launches one chunk; cudaErrorInvalidValue for a geometry the tile does
// not take (odd tj or halo, ns beyond halo / 2, a batch outside [1, 65535];
// compacted: a domain that is not a whole grid of even width).
template <bool kCompact = false>
cudaError_t launch_tile_chunk(const TileChunk& t, cudaStream_t s) {
  if (t.ti < 1 || t.tj < 2 || (t.tj & 1) || t.halo < 0 || (t.halo & 1) ||
      t.ns < 0 || 2 * t.ns > t.halo || t.batch < 1 || t.batch > 65535) {
    return cudaErrorInvalidValue;
  }
  if (kCompact &&
      ((t.dom.cols & 1) || t.dom.off_i || t.dom.off_j ||
       t.dom.rows != t.dom.ni || t.dom.cols != t.dom.nj || t.dom.w_lo_i ||
       t.dom.w_lo_j || t.dom.w_hi_i != t.dom.rows ||
       t.dom.w_hi_j != t.dom.cols)) {
    return cudaErrorInvalidValue;
  }
  const TileGeometry g = tile_geometry(t.ti, t.tj, t.halo);
  if (g.hot < 0 && g.pc * g.rs > kTileMaxThreads) {
    return cudaErrorInvalidValue;
  }
  const void* fn = nullptr;
  cudaError_t err = tile_kernel<kCompact>(g, &fn);
  if (err != cudaSuccess) return err;
  const dim3 grid((t.dom.cols + t.tj - 1) / t.tj,
                  (t.dom.rows + t.ti - 1) / t.ti, t.batch);
  TileChunk arg = t;
  void* args[] = {&arg};
  err = cudaLaunchKernel(fn, grid, dim3(g.pc, g.rs), args, g.smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// n_sweeps sweeps of a whole grid from delta = 0 in chunks of
// sweeps_per_chunk (a short last one; none: one chunk of no sweeps, which
// writes zeros), t's geometry and constants: t.dst and t.src (and, in the
// compacted layout, t.dst1 and t.src1) take turns as a chunk's output and
// input, t.dst first, so the result is in the first t.dst when the number
// of chunks is odd, else in the first t.src.  Every chunk writes every cell
// of its output, so neither buffer needs initialising.  The loop of B1, B4
// (tile_sweeps_from_zero) and B5 (sor_compressed.cu).
template <bool kCompact = false>
cudaError_t tile_chunks_from_zero(TileChunk t, int n_sweeps,
                                  int sweeps_per_chunk, cudaStream_t s) {
  if (sweeps_per_chunk < 1 || n_sweeps < 0) return cudaErrorInvalidValue;
  t.halo = 2 * sweeps_per_chunk;
  t.zero_src = 1;
  int done = 0;
  do {
    t.ns = n_sweeps - done < sweeps_per_chunk ? n_sweeps - done
                                              : sweeps_per_chunk;
    const cudaError_t err = launch_tile_chunk<kCompact>(t, s);
    if (err != cudaSuccess) return err;
    done += t.ns;
    float* next_dst = const_cast<float*>(t.src);
    t.src = t.dst;
    t.dst = next_dst;
    float* next_dst1 = const_cast<float*>(t.src1);
    t.src1 = t.dst1;
    t.dst1 = next_dst1;
    t.zero_src = 0;
  } while (done < n_sweeps);
  return cudaGetLastError();
}

// tile_chunks_from_zero on `batch` whole ni x nj grids, stored one after
// the other: d and scratch take turns, scratch first, so the result is in
// scratch when the number of chunks is odd, else in d.  The loop of B1 and
// B4 (sor_tiled.cu).
cudaError_t tile_sweeps_from_zero(float* d, float* scratch, const float* rhs,
                                  int batch, int ni, int nj, int n_sweeps,
                                  int tile_rows,
                                  int tile_cols, int sweeps_per_chunk,
                                  float one_minus_omega, float coef,
                                  float dx2_inv, float dy2_inv,
                                  cudaStream_t s) {
  TileChunk t{d,         scratch,   rhs,
              {ni, nj, 0, 0, ni, nj, 0, ni, 0, nj},
              tile_rows, tile_cols, 0,
              0,         1,         one_minus_omega,
              coef,      dx2_inv,   dy2_inv};
  t.batch = batch;
  t.member_stride = static_cast<size_t>(ni) * nj;
  return tile_chunks_from_zero(t, n_sweeps, sweeps_per_chunk, s);
}

// The geometry of a tile in the layout and the blocks of it one SM holds:
// out[0..6] = shared rows, shared columns, rows per thread (0: rhs not in
// registers), threads per block, shared bytes, resident blocks per SM,
// registers per thread.
template <bool kCompact = false>
cudaError_t tile_report(int ti, int tj, int halo, int* out) {
  if (ti < 1 || tj < 2 || (tj & 1) || halo < 0 || (halo & 1)) {
    return cudaErrorInvalidValue;
  }
  const TileGeometry g = tile_geometry(ti, tj, halo);
  const void* fn = nullptr;
  cudaError_t err = tile_kernel<kCompact>(g, &fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      g.pc * g.rs, g.smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  out[0] = g.er;
  out[1] = 2 * g.pc;
  out[2] = g.m;
  out[3] = g.pc * g.rs;
  out[4] = static_cast<int>(g.smem);
  out[5] = blocks;
  out[6] = attr.numRegs;
  return cudaSuccess;
}

}  // namespace

}  // namespace nsp
