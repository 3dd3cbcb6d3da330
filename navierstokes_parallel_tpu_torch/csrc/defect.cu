// The f64 refinement outer's pass after its inner stage, in one launch:
// master update, Neumann ghost, defect, the next pass's rhs, the L2 norm and
// the stop test, for one problem or for every member of a batch.
//
// nsp_pressure_defect replaces no TPU kernel: the JAX package's outer
// (ops/sor.py::_solve_pressure_refined there) is jnp, which XLA fuses.  The
// port ran it as ~28 plain PyTorch launches a pass (~31 for a batch; ops/
// cuda/defect_kernel.py::outer_pass_plain, kept as its twin), each a few
// microseconds of device time behind ~20 us of the host's launch cost.  With
// the default hooks (ops/sor.py::_fused_outer) the pass after the inner is
// this one launch, for one problem or a whole batch; the host still reads
// the go-on flag (a batch's any() of its flags) once a pass.
//
// What bounds it on an H100: device memory.  Per interior cell it reads the
// master (8 B), delta (4 B) and rhs (8 B) and writes the new master (8 B)
// and the next pass's rhs (4 B), 32 B against ~12 f64 operations: 134 MB
// and 40 us at 2050^2, 2.1 MB and 0.6 us at 258^2 (16.8 MB and 5 us for 8
// members of 258^2), where the launch and the last block's sum set the
// time.
//
// The grid's z axis is the member: block (x, y, m) works on member m's
// planes of the master, its spare, delta and rhs_full ((i_max + 2) nj
// apart) and its rhs (rhs_member_stride apart), with member m's flag,
// count, norm and threshold, its own row of block partials and its own
// ticket.  One problem is one member: the same grid in x and y, the same
// blocks and the same bits as a launch over its plane alone.
//
// A block owns kTileRows x kTileCols interior cells.  It stages the new
// master over the tile and a one-cell ring in shared memory, each cell
// formed once from the old master and delta (old + f64(delta) while the
// member goes on, else old), with the indices clamped into the interior:
// the clamp is the homogeneous Neumann ghost (the cell across a wall equals
// the adjacent interior cell, what ops/sor.py::ghost_fill writes; corners
// are never read).  The new master goes to a second buffer, never in place:
// a block's stencil reads its neighbours' old masters while other blocks
// write theirs.  Neither buffer's ghost ring is written.
//
// The defect keeps ops/sor.py::residual's order of operations, each
// rounded once (__dadd_rn and the like, which nvcc never contracts into an
// FMA), so the new master, r and f32(-r) equal the plain chain's bits.
// Each block sums its r^2 in a fixed order into one partial; the member's
// last block to finish (a threadfence, then an atomic on the member's
// ticket) sums the member's partials in block order, forms sqrt(sum /
// (i_max j_max)) as ops/stencils.py::l2_norm does, sets res_norm,
// iterations += on * n_inner and on &= norm > threshold as the plain chain
// does (a member already stopped keeps its master, norm and count), and
// resets the ticket for the next launch.  The order of the sum is not
// torch.sum's: the norm agrees with the plain chain's to rounding, two
// launches give the same bits, and a member of a batch gets the bits of
// its own launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTileCols = 32;  // a warp along j, the contiguous axis
constexpr int kTileRows = 16;
constexpr int kThreadsJ = 32;
constexpr int kThreadsI = 8;   // each thread takes kTileRows / kThreadsI rows
constexpr int kThreads = kThreadsJ * kThreadsI;
constexpr int kSharedRows = kTileRows + 2;
constexpr int kSharedCols = kTileCols + 2;

// Every pointer is member 0's; member m's lies a plane (the padded
// (i_max + 2) x nj), rhs_member_stride, one flag or one workspace row on.
struct Args {
  const double* p_old;  // padded (i_max + 2) x nj master, read
  double* p_new;        // the same shape, its interior written
  const float* delta;   // padded f32 correction of the inner stage
  const double* rhs;    // interior rhs, rows rhs_stride apart
  float* rhs_full;      // padded f32 rhs of the next inner, interior written
  unsigned char* on;    // the go-on flags (torch.bool), one a member
  long long* iterations;
  double* res_norm;
  const double* threshold;
  double* workspace;    // a row a member: a partial per block, its ticket
  long long rhs_member_stride;
  int i_max, j_max, nj, rhs_stride, n_inner;
  double dx2_inv, dy2_inv;
};

// The sum of v over the block, in a fixed order (each warp by shuffles,
// then the warps in order); valid in thread 0.  `sums` holds kThreadsI
// doubles and may be reused after the next __syncthreads.
__device__ __forceinline__ double block_sum(double v, double* sums) {
  for (int off = kThreadsJ / 2; off > 0; off >>= 1) {
    v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  if (threadIdx.x == 0) sums[threadIdx.y] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    for (int w = 0; w < kThreadsI; ++w) total = __dadd_rn(total, sums[w]);
  }
  return total;
}

__global__ void __launch_bounds__(kThreads) pressure_defect(Args a) {
  __shared__ double p[kSharedRows][kSharedCols];
  __shared__ double sums[kThreadsI];
  __shared__ bool last;
  const int t = threadIdx.y * kThreadsJ + threadIdx.x;
  // Padded indices of the cell before the tile's first: shared row / column
  // s holds padded row i0 + s / column j0 + s.
  const int i0 = blockIdx.y * kTileRows;
  const int j0 = blockIdx.x * kTileCols;
  const int m = blockIdx.z;
  const long long plane = static_cast<long long>(a.i_max + 2) * a.nj;
  const double* p_old = a.p_old + m * plane;
  double* p_new = a.p_new + m * plane;
  const float* delta = a.delta + m * plane;
  float* rhs_full = a.rhs_full + m * plane;
  const double* rhs = a.rhs + m * a.rhs_member_stride;
  const int n_blocks = gridDim.x * gridDim.y;  // a member's
  double* partials = a.workspace + static_cast<long long>(m) * (n_blocks + 1);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(partials + n_blocks);
  const bool going = a.on[m] != 0;

  for (int s = t; s < kSharedRows * kSharedCols; s += kThreads) {
    const int si = s / kSharedCols;
    const int sj = s % kSharedCols;
    const int gi = min(max(i0 + si, 1), a.i_max);
    const int gj = min(max(j0 + sj, 1), a.j_max);
    const long long k = static_cast<long long>(gi) * a.nj + gj;
    const double old = p_old[k];
    p[si][sj] = going ? __dadd_rn(old, static_cast<double>(delta[k])) : old;
  }
  __syncthreads();

  double sq = 0.0;
  const int sj = threadIdx.x + 1;
  const int gj = j0 + sj;
  for (int si = threadIdx.y + 1; si <= kTileRows; si += kThreadsI) {
    const int gi = i0 + si;
    if (gi > a.i_max || gj > a.j_max) continue;
    const double c = p[si][sj];
    const double two_c = __dmul_rn(2.0, c);
    // ((p[i+1] - 2 p) + p[i-1]) dx2_inv + ((p[j+1] - 2 p) + p[j-1]) dy2_inv
    // - rhs
    const double lap_x = __dmul_rn(
        __dadd_rn(__dsub_rn(p[si + 1][sj], two_c), p[si - 1][sj]), a.dx2_inv);
    const double lap_y = __dmul_rn(
        __dadd_rn(__dsub_rn(p[si][sj + 1], two_c), p[si][sj - 1]), a.dy2_inv);
    const double r = __dsub_rn(
        __dadd_rn(lap_x, lap_y),
        rhs[static_cast<long long>(gi - 1) * a.rhs_stride + (gj - 1)]);
    const long long k = static_cast<long long>(gi) * a.nj + gj;
    p_new[k] = c;
    rhs_full[k] = -__double2float_rn(r);
    sq = __dadd_rn(sq, __dmul_rn(r, r));
  }

  const double partial = block_sum(sq, sums);
  if (t == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = partial;
    __threadfence();
    last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(n_blocks - 1);
  }
  __syncthreads();
  if (!last) return;

  // The member's last block: every partial of the member is written and
  // fenced.
  __threadfence();
  double s = 0.0;
  for (int b = t; b < n_blocks; b += kThreads) {
    s = __dadd_rn(s, __ldcg(partials + b));
  }
  const double total = block_sum(s, sums);
  if (t == 0) {
    const double norm = __dsqrt_rn(__ddiv_rn(
        total, static_cast<double>(a.i_max) * static_cast<double>(a.j_max)));
    if (going) {
      a.res_norm[m] = norm;
      a.iterations[m] += a.n_inner;
    }
    // A NaN norm stops the member, as the plain chain's comparison does.
    a.on[m] = (going && norm > a.threshold[m]) ? 1 : 0;
    *ticket = 0u;
  }
}

}  // namespace

// The pass after the inner stage (see the note at the top) of `members`
// problems whose planes lie one after another: reads p_old, delta and rhs,
// writes p_new's and rhs_full's interiors, updates on, iterations and
// res_norm (one each a member).  workspace holds workspace_len doubles: a
// row a member of one partial per block and, after them, the member's
// ticket, zero before the first launch (each launch leaves it zero).
// Returns cudaGetLastError() after the launch.
extern "C" int nsp_pressure_defect(const double* p_old, double* p_new,
                                   const float* delta, const double* rhs,
                                   int rhs_stride, long long rhs_member_stride,
                                   float* rhs_full, unsigned char* on,
                                   long long* iterations, double* res_norm,
                                   const double* threshold, double* workspace,
                                   int workspace_len, int members, int i_max,
                                   int j_max, int n_inner, double dx2_inv,
                                   double dy2_inv, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_j = (j_max + kTileCols - 1) / kTileCols;
  const int blocks_i = (i_max + kTileRows - 1) / kTileRows;
  if (i_max < 1 || j_max < 1 || blocks_i > 65535 || members < 1 ||
      members > 65535 ||
      workspace_len < static_cast<long long>(members) *
                          (blocks_i * blocks_j + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{p_old, p_new, delta, rhs, rhs_full, on, iterations, res_norm,
         threshold, workspace, rhs_member_stride,
         i_max, j_max, j_max + 2, rhs_stride, n_inner, dx2_inv, dy2_inv};
  pressure_defect<<<dim3(blocks_j, blocks_i, members),
                    dim3(kThreadsJ, kThreadsI), 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
