// One skewed block of the cross-device Smith-Waterman wavefront (Gotoh,
// score only): U anti-diagonal steps of one rank's strip of w rows of x, for
// the 128 lanes of a tile, from the carried state, for Hopper (sm_90a).
//
// Replaces: genomax/dist/xsharded.py `_strip_block_pallas`. Same function:
// sxb (w, 128) int8 x codes of the strip; slab (w+U, 128) int8 stream rows,
// the window of in-block step tt being slab[U-tt : U-tt+w); hD, hQ (U, 128)
// int32, the left neighbour's last-row D and Q of each step (zeros on rank
// 0); the state P1, D1, D1s, Q1s, D2s, mx, six (w, 128) int32 in and out;
// bD, bQ (U, 128) int32 out, this strip's last-row Dn and Qn of each step.
// Per step:
//   Pn = max(D1, P1 + ge)          Qn = max(D1s, Q1s + ge)
//   Dn = max(max(Pn, Qn) + go + ge, max(D2s + sub, 0))     mx = max(mx, Dn)
// then D2s <- D1s, and D1s, Q1s <- Dn, Qn of the row above (row 0: hD, hQ
// of the step, where the TPU kernel's roll would wrap the last row round).
// There are no boundary pins and no masks: the pack's pad codes make the
// cells outside a pair's matrix decay, as in the TPU kernel.
//
// Design: one block per lane, R <= 1024 threads, one thread a row. The
// strip (w = 50,008 rows at 50kbp on one card) is walked in sub-strips of R
// rows; each sub-strip loads its rows' state once, runs all U steps with one
// __syncthreads a step (D and Q of the row above from a ping-pong pair of
// shared rows, as in sw_long.cu), and stores its state once, so the state
// costs 48 / U bytes a cell. Sub-strip j's last row writes its Dn and Qn of
// each step into a U-entry shared buffer, which sub-strip j+1's row 0 reads
// in place of hD and hQ (D2s needs no halo: it is the previous step's D1s).
// The first sub-strip reads hD and hQ, the row w-1 writes bD and bQ. The
// stream codes of a sub-strip, R+U-1 of them, are staged in shared memory
// once: step tt of row r reads slab row g0 + r + U - tt.
//
// The state lives in device memory between launches (6 x w x 128 x 4 B =
// 153.6 MB at 50kbp), at any strides the wrapper passes: the forward keeps it
// lane-major, so that a warp's 32 rows of one lane are 128 contiguous bytes.
// It may be updated in place (out == in): each element is read and then
// written by the one thread that owns its row.
//
// Bound on this card: operations. A launch does about 13 integer operations
// a cell over w * U * 128 cells and moves 48 B a row and lane of state plus
// the codes; at U = 32 the operations take about twice the bytes' time.
// What holds it above that bound: one block barrier a step for a block of
// up to 1,024 threads, and 128 blocks on 132 SMs. Several lanes a block,
// several rows a thread and DPX max intrinsics are the levers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // pairs per packed tile

__global__ void __launch_bounds__(1024)
sw_xstrip_kernel(const int8_t* __restrict__ sxb,
                 const int8_t* __restrict__ slab,
                 const int32_t* __restrict__ hD, const int32_t* __restrict__ hQ,
                 const int32_t* P1i, const int32_t* D1i, const int32_t* D1si,
                 const int32_t* Q1si, const int32_t* D2si, const int32_t* mxi,
                 int32_t* P1o, int32_t* D1o, int32_t* D1so, int32_t* Q1so,
                 int32_t* D2so, int32_t* mxo, int32_t* __restrict__ bD,
                 int32_t* __restrict__ bQ, int w, int U, long long srow,
                 long long slane, int match, int mismatch, int oge, int ge) {
  extern __shared__ int32_t smem[];
  const int R = blockDim.x;
  int32_t* const sd = smem;           // [2][R]: Dn of each row, by step parity
  int32_t* const sq = smem + 2 * R;   // [2][R]: Qn of each row
  int32_t* hin = smem + 4 * R;        // [2][U]: D, Q of the row above row 0
  int32_t* hout = hin + 2 * U;        // [2][U]: D, Q of the last row
  int32_t* const ys = hout + 2 * U;   // [R + U]: stream codes, ys[m] = row g0+m

  const int l = blockIdx.x;
  const int r = threadIdx.x;
  for (int t = r; t < U; t += R) {
    hin[t] = hD[static_cast<size_t>(t) * kLanes + l];
    hin[U + t] = hQ[static_cast<size_t>(t) * kLanes + l];
  }

  for (int g0 = 0; g0 < w; g0 += R) {
    const int g = g0 + r;
    const bool act = g < w;
    const long long at = g * srow + l * slane;
    int P1 = 0, D1 = 0, D1s = 0, Q1s = 0, D2s = 0, mx = 0, xc = 0;
    if (act) {
      P1 = P1i[at];
      D1 = D1i[at];
      D1s = D1si[at];
      Q1s = Q1si[at];
      D2s = D2si[at];
      mx = mxi[at];
      xc = sxb[static_cast<size_t>(g) * kLanes + l];
    }
    for (int m = r + 1; m < R + U && g0 + m < w + U; m += R) {
      ys[m] = slab[static_cast<size_t>(g0 + m) * kLanes + l];
    }
    __syncthreads();  // ys and hin written

    const bool last_row = g == w - 1;
    const bool seam_row = r == R - 1 && g0 + R < w;
    for (int tt = 0; tt < U; ++tt) {
      const int pn = max(D1, P1 + ge);
      const int qn = max(D1s, Q1s + ge);
      const int sub = ys[r + U - tt] == xc ? match : mismatch;
      const int dn = max(max(pn, qn) + oge, max(D2s + sub, 0));
      mx = max(mx, dn);
      int32_t* const sdb = sd + (tt & 1) * R;
      int32_t* const sqb = sq + (tt & 1) * R;
      sdb[r] = dn;
      sqb[r] = qn;
      if (last_row) {
        bD[static_cast<size_t>(tt) * kLanes + l] = dn;
        bQ[static_cast<size_t>(tt) * kLanes + l] = qn;
      }
      if (seam_row) {
        hout[tt] = dn;
        hout[U + tt] = qn;
      }
      __syncthreads();
      const int d1sn = r > 0 ? sdb[r - 1] : hin[tt];
      const int q1sn = r > 0 ? sqb[r - 1] : hin[U + tt];
      P1 = pn;
      D2s = D1s;
      D1 = dn;
      D1s = d1sn;
      Q1s = q1sn;
    }
    if (act) {
      P1o[at] = P1;
      D1o[at] = D1;
      D1so[at] = D1s;
      Q1so[at] = Q1s;
      D2so[at] = D2s;
      mxo[at] = mx;
    }
    __syncthreads();  // row 0's last reads of hin, everyone's of ys
    int32_t* const t = hin;
    hin = hout;
    hout = t;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(). The
// caller checks shapes (sxb (w, 128), slab (w+U, 128) contiguous int8; hD,
// hQ, bD, bQ (U, 128) contiguous int32; the 12 state arrays (w, 128) int32
// at the strides srow, slane, each output either its input or disjoint from
// every input) and picks `threads` (R, a multiple of 32 up to 1,024).
extern "C" int sw_xstrip_launch(
    const void* sxb, const void* slab, const void* hD, const void* hQ,
    const void* P1i, const void* D1i, const void* D1si, const void* Q1si,
    const void* D2si, const void* mxi, void* P1o, void* D1o, void* D1so,
    void* Q1so, void* D2so, void* mxo, void* bD, void* bQ, int w, int U,
    int threads, long long srow, long long slane, int match, int mismatch,
    int gap_open, int gap_extend, void* stream) {
  const size_t smem =
      static_cast<size_t>(5 * threads + 5 * U) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_xstrip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sw_xstrip_kernel<<<kLanes, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(sxb), static_cast<const int8_t*>(slab),
      static_cast<const int32_t*>(hD), static_cast<const int32_t*>(hQ),
      static_cast<const int32_t*>(P1i), static_cast<const int32_t*>(D1i),
      static_cast<const int32_t*>(D1si), static_cast<const int32_t*>(Q1si),
      static_cast<const int32_t*>(D2si), static_cast<const int32_t*>(mxi),
      static_cast<int32_t*>(P1o), static_cast<int32_t*>(D1o),
      static_cast<int32_t*>(D1so), static_cast<int32_t*>(Q1so),
      static_cast<int32_t*>(D2so), static_cast<int32_t*>(mxo),
      static_cast<int32_t*>(bD), static_cast<int32_t*>(bQ), w, U, srow, slane,
      match, mismatch, gap_open + gap_extend, gap_extend);
  return static_cast<int>(cudaGetLastError());
}
