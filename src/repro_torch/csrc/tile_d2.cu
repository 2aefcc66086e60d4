// tile_d2.cu — the masked Eq. (3) squared-distance tile, in IEEE fp32.
//
// Replaces the TPU kernel `_tile_d2_kernel` (src/repro/kernels/registry.py:263),
// launched by `tile_d2_pallas` (src/repro/kernels/registry.py:280).
//
//   d2[i, j] = max(2s * (1 - (q_i . c_j - s*muq_i*muc_j) / (s*sigq_i*sigc_j)), 0)
//   d2[i, j] = +inf where |qid_i - cid_j| < s, or either id is outside [0, n_valid)
//
// Bound on an H100 SXM: 2*Bq*Bc*s fp32 operations at 67 TFLOP/s (the CUDA
// cores; the exact plane promises IEEE fp32, so no TF32 or bf16 tensor
// cores) against (Bq + Bc)*s*4 bytes read and Bq*Bc*4 bytes written at
// 3.35 TB/s.  At the main path's [Bq, Bc, s] = [256, 131072, 256] that is
// 0.256 ms of FMA against about 0.08 ms for the 270 MB moved (134 MB of
// candidate windows read, 134 MB of tile written), so the kernel is bound
// by operations.
//
// Design: a shared-memory tiled SGEMM with a register micro-tile.  One block
// of 256 threads owns a 128 x 128 output tile; each thread accumulates an
// 8 x 8 micro-tile (rows and columns in two runs of 4, 64 apart, so that
// the shared-memory reads are float4 and the output rows are written as
// float4 runs).  The k-loop walks the window in steps of 16 samples: the
// next step's operands are loaded into registers while the current step
// is multiplied out of the other of two shared buffers, so one barrier per
// step suffices.  Both operands are K-major (a window is a row), and the
// loader transposes them into [k][row] shared tiles.  Ragged Bq, Bc and s
// are masked in the kernel itself: out-of-range operands load as 0 and
// out-of-range outputs are not written.  Bc, up to 2^17 on the main path,
// runs along gridDim.x.  The epilogue applies Eq. (3) in the order of
// znorm_d2_formula, with every product, difference and quotient rounded
// once (the _rn intrinsics keep the compiler from fusing them), then the
// mask.  Not fused here: the row min/argmin of the profile sweep.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 128;                    // query rows per block
constexpr int BN = 128;                    // candidate columns per block
constexpr int BK = 16;                     // window samples per k-step
constexpr int TM = 8;                      // micro-tile rows per thread
constexpr int TN = 8;                      // micro-tile columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);
constexpr int PAD = 4;                     // keeps shared rows 16-byte aligned
constexpr int LOADS = BM * BK / THREADS;   // operand elements per thread
constexpr int LSTRIDE = THREADS / BK;      // row stride of the loader

static_assert(BM == BN, "one loader mapping serves both operands");
static_assert(THREADS == 256 && LOADS == 8, "tile geometry");

// i-th of a thread's 8 rows (or columns): t*4 + {0..3}, then 64 + t*4 + {0..3}
__device__ __forceinline__ int micro(int t, int i) {
    return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

__global__ void __launch_bounds__(THREADS)
tile_d2_kernel(const float* __restrict__ q, const float* __restrict__ qmu,
               const float* __restrict__ qsig, const int* __restrict__ qid,
               const float* __restrict__ c, const float* __restrict__ cmu,
               const float* __restrict__ csig, const int* __restrict__ cid,
               float* __restrict__ out, int bq, int bc, int s, int n_valid)
{
    __shared__ __align__(16) float As[2][BK][BM + PAD];
    __shared__ __align__(16) float Bs[2][BK][BN + PAD];

    const int tid = threadIdx.x;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    const int ty = tid / (BN / TN);
    const int tx = tid % (BN / TN);
    const int lk = tid % BK;               // loader: sample within the step
    const int lr = tid / BK;               // loader: first row, then +LSTRIDE

    float ra[LOADS], rb[LOADS];
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    const int nk = (s + BK - 1) / BK;

    // step 0 -> registers -> shared buffer 0
    {
        const bool kin = lk < s;
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
            const int r = row0 + lr + LSTRIDE * i;
            const int cc = col0 + lr + LSTRIDE * i;
            ra[i] = (kin && r < bq) ? q[(size_t)r * s + lk] : 0.0f;
            rb[i] = (kin && cc < bc) ? c[(size_t)cc * s + lk] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
            As[0][lk][lr + LSTRIDE * i] = ra[i];
            Bs[0][lk][lr + LSTRIDE * i] = rb[i];
        }
    }
    __syncthreads();

    for (int t = 0; t < nk; ++t) {
        const int buf = t & 1;
        const bool more = t + 1 < nk;
        if (more) {
            const int k = (t + 1) * BK + lk;
            const bool kin = k < s;
#pragma unroll
            for (int i = 0; i < LOADS; ++i) {
                const int r = row0 + lr + LSTRIDE * i;
                const int cc = col0 + lr + LSTRIDE * i;
                ra[i] = (kin && r < bq) ? q[(size_t)r * s + k] : 0.0f;
                rb[i] = (kin && cc < bc) ? c[(size_t)cc * s + k] : 0.0f;
            }
        }
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
            const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (more) {
#pragma unroll
            for (int i = 0; i < LOADS; ++i) {
                As[buf ^ 1][lk][lr + LSTRIDE * i] = ra[i];
                Bs[buf ^ 1][lk][lr + LSTRIDE * i] = rb[i];
            }
        }
        __syncthreads();
    }

    // epilogue: Eq. (3) in znorm_d2_formula's order, then the mask
    const float sf = (float)s;
    const float two_s = 2.0f * sf;
    float cm[TN], cs[TN];
    bool cbad[TN];
    int ci[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const int col = col0 + micro(tx, j);
        const bool in = col < bc;
        cm[j] = in ? cmu[col] : 0.0f;
        cs[j] = in ? csig[col] : 1.0f;
        ci[j] = in ? cid[col] : -1;
        cbad[j] = ci[j] < 0 || ci[j] >= n_valid;
    }
    const bool vec = (bc % 4) == 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + micro(ty, i);
        if (r >= bq) continue;
        const int idq = qid[r];
        const bool qbad = idq < 0 || idq >= n_valid;
        const float smq = __fmul_rn(sf, qmu[r]);
        const float ssq = __fmul_rn(sf, qsig[r]);
        float d[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const long long gap = (long long)idq - (long long)ci[j];
            if (qbad || cbad[j] || (gap < 0 ? -gap : gap) < s) {
                d[j] = INFINITY;
            } else {
                const float corr = __fdiv_rn(
                    __fsub_rn(acc[i][j], __fmul_rn(smq, cm[j])),
                    __fmul_rn(ssq, cs[j]));
                const float v = __fmul_rn(two_s, __fsub_rn(1.0f, corr));
                d[j] = v < 0.0f ? 0.0f : v;   // NaN passes, as jnp.maximum
            }
        }
        float* orow = out + (size_t)r * bc;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int col = col0 + h * 64 + tx * 4;
            if (vec && col + 3 < bc) {
                *reinterpret_cast<float4*>(orow + col) =
                    make_float4(d[4 * h], d[4 * h + 1], d[4 * h + 2], d[4 * h + 3]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (col + j < bc) orow[col + j] = d[4 * h + j];
            }
        }
    }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was taken).
extern "C" int tile_d2_launch(const float* q, const float* qmu, const float* qsig,
                              const int* qid, const float* c, const float* cmu,
                              const float* csig, const int* cid, float* out,
                              int bq, int bc, int s, int n_valid, void* stream)
{
    const dim3 grid((unsigned)((bc + BN - 1) / BN), (unsigned)((bq + BM - 1) / BM));
    tile_d2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        q, qmu, qsig, qid, c, cmu, csig, cid, out, bq, bc, s, n_valid);
    return (int)cudaGetLastError();
}
