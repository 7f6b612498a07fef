// K7 and K8: batched rfft of real rows for N = n1 * n2 >= 16384, four-step
// in two passes through global memory, for Hopper (fp32 SIMT).
//
// Replaces the TPU kernels dsp_audio_project_tpu/kernels/rfft.py:
// rfft_pallas_four_step_tall (K7, N = 16384..524288, one pass in VMEM) and
// rfft_pallas_two_level (K8, N = 1048576, two passes through HBM).  Both
// are the same factorisation, j = j1*n2 + j2 and k = k1 + n1*k2:
//
//   pass 1 (column DFT + twiddle):
//       B[k1, j2] = TW[k1, j2] * sum_j1 x[j1*n2 + j2] * W_n1^{j1 k1}
//   pass 2 (row DFT, bins 0 .. N/2 only):
//       X[k1 + n1*k2] = sum_j2 B[k1, j2] * W_n2^{j2 k2},  k2 < n2/2,
//       X[N/2]        = sum_j2 B[0, j2] * (-1)^j2,
//   then |X| (MAG) or X as interleaved (re, im) floats (complex64).
//
// On the TPU only K8 stages B through HBM, because VMEM is small.  On the
// H100 one N = 32768 row's B alone is 256 KB, more than a block's 227 KB
// of shared memory, so B is staged through global memory for every N, as
// two fp32 planes stored [j2][k1] (rows, 2, n2, n1).
//
// Both passes are direct sums, complex GEMMs per row: pass 1 is
// (n1 x n1) @ (n1 x n2) with a real right side, pass 2 is (n1 x n2) @
// (n2 x n2/2).  That is 2 N (n1 + n2) FMAs a row, least at the balanced
// split n1 = n2 = sqrt(N) that the wrapper picks; what bounds them on an
// H100 is the fp32 FMA rate (torch.fft.rfft, O(N log N), is bound by
// bytes).  Design: one 64 x 64 output tile per block, 256 threads with a
// 4 x 4 micro-tile each, TK = 16 deep slabs of both operands in shared
// memory loaded as float4 (m-contiguous A^T, n-contiguous B), sums as
// plain fp32 FMAs against fp32 tables built from float64 and read through
// L2.  Every operand load and every store is contiguous along the tile:
// pass 1 reads x along j2 and writes B^T along k1; pass 2 reads B^T along
// k1, the row-DFT table along k2, and writes X along k1 (k = k1 + n1*k2).
// The Nyquist bin k2 = n2/2 is one extra reduction over B[0, :], done by
// warp 0 of each row's first pass-2 block, so the tiles stay 64-aligned.
// Grids are (rows, n tiles, m tiles): rows ride grid.x (2^31 - 1), the
// tile counts are at most 16 at N = 1048576.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // tile rows (k1)
constexpr int TN = 64;        // tile columns (j2 in pass 1, k2 in pass 2)
constexpr int TK = 16;        // contraction slab depth
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float4 ld4(const float* p)
{
    return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v)
{
    *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void unpack(float4 v, float (&a)[4])
{
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

// Pass 1.  Grid (rows, n2 / TN, n1 / TM).  d1: (2, n1, n1) W_n1^{j1 k1}
// (symmetric), tw: (2, n2, n1) W_N^{k1 j2} stored [j2][k1], b: (rows, 2,
// n2, n1) B stored [j2][k1].
__global__ void __launch_bounds__(THREADS)
two_pass_stage1(const float* __restrict__ x, const float* __restrict__ d1,
                const float* __restrict__ tw, float* __restrict__ b,
                int n1, int n2)
{
    __shared__ __align__(16) float a_re[TK][TM];
    __shared__ __align__(16) float a_im[TK][TM];
    __shared__ __align__(16) float xs[TK][TN];

    const int64_t n = (int64_t)n1 * n2;
    const int64_t row = blockIdx.x;
    const int n0 = blockIdx.y * TN;        // j2
    const int m0 = blockIdx.z * TM;        // k1
    const int tid = threadIdx.x;
    const int tm = tid % 16, tn = tid / 16;
    const int lk = tid / 16, lc = (tid % 16) * 4;   // loader: slab row, col
    const float* xr = x + row * n;
    const float* d1i = d1 + (int64_t)n1 * n1;

    float cr[4][4] = {}, ci[4][4] = {};
    for (int k0 = 0; k0 < n1; k0 += TK) {
        const int64_t kk = k0 + lk;
        st4(&a_re[lk][lc], ld4(d1 + kk * n1 + m0 + lc));
        st4(&a_im[lk][lc], ld4(d1i + kk * n1 + m0 + lc));
        st4(&xs[lk][lc], ld4(xr + kk * n2 + n0 + lc));
        __syncthreads();
#pragma unroll
        for (int k = 0; k < TK; ++k) {
            float ar[4], ai[4], xv[4];
            unpack(*reinterpret_cast<const float4*>(&a_re[k][tm * 4]), ar);
            unpack(*reinterpret_cast<const float4*>(&a_im[k][tm * 4]), ai);
            unpack(*reinterpret_cast<const float4*>(&xs[k][tn * 4]), xv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    cr[i][j] = fmaf(ar[i], xv[j], cr[i][j]);
                    ci[i][j] = fmaf(ai[i], xv[j], ci[i][j]);
                }
        }
        __syncthreads();
    }

    float* br = b + row * 2 * n;
    float* bi = br + n;
    const float* twi = tw + n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int64_t off = (int64_t)(n0 + tn * 4 + j) * n1 + m0 + tm * 4;
        float wr[4], wi[4], outr[4], outi[4];
        unpack(ld4(tw + off), wr);
        unpack(ld4(twi + off), wi);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            outr[i] = cr[i][j] * wr[i] - ci[i][j] * wi[i];
            outi[i] = cr[i][j] * wi[i] + ci[i][j] * wr[i];
        }
        st4(br + off, make_float4(outr[0], outr[1], outr[2], outr[3]));
        st4(bi + off, make_float4(outi[0], outi[1], outi[2], outi[3]));
    }
}

template <bool MAG>
__device__ __forceinline__ void store_bin(void* out, int64_t i, float re,
                                          float im)
{
    if constexpr (MAG)
        static_cast<float*>(out)[i] = sqrtf(re * re + im * im);
    else
        static_cast<float2*>(out)[i] = make_float2(re, im);
}

// Pass 2.  Grid (rows, (n2/2) / TN, n1 / TM).  b: pass 1's B^T planes,
// d2: (2, n2, n2/2) W_n2^{j2 k2} stored [j2][k2], out: (rows, N/2 + 1).
template <bool MAG>
__global__ void __launch_bounds__(THREADS)
two_pass_stage2(const float* __restrict__ b, const float* __restrict__ d2,
                void* __restrict__ out, int n1, int n2)
{
    __shared__ __align__(16) float a_re[TK][TM];
    __shared__ __align__(16) float a_im[TK][TM];
    __shared__ __align__(16) float w_re[TK][TN];
    __shared__ __align__(16) float w_im[TK][TN];

    const int64_t n = (int64_t)n1 * n2;
    const int h2 = n2 / 2;
    const int64_t row = blockIdx.x;
    const int n0 = blockIdx.y * TN;        // k2
    const int m0 = blockIdx.z * TM;        // k1
    const int tid = threadIdx.x;
    const int tm = tid % 16, tn = tid / 16;
    const int lk = tid / 16, lc = (tid % 16) * 4;
    const float* br = b + row * 2 * n;
    const float* bi = br + n;
    const float* d2i = d2 + (int64_t)n2 * h2;
    const int64_t obase = row * (n / 2 + 1);

    if (blockIdx.y == 0 && blockIdx.z == 0 && tid < 32) {
        // X[N/2] = sum_j2 B[0, j2] (-1)^j2.
        float sr = 0.f, si = 0.f;
        for (int j2 = tid; j2 < n2; j2 += 32) {
            const float s = (j2 & 1) ? -1.f : 1.f;
            sr = fmaf(s, br[(int64_t)j2 * n1], sr);
            si = fmaf(s, bi[(int64_t)j2 * n1], si);
        }
        for (int o = 16; o > 0; o >>= 1) {
            sr += __shfl_down_sync(0xffffffffu, sr, o);
            si += __shfl_down_sync(0xffffffffu, si, o);
        }
        if (tid == 0) store_bin<MAG>(out, obase + n / 2, sr, si);
    }

    float cr[4][4] = {}, ci[4][4] = {};
    for (int k0 = 0; k0 < n2; k0 += TK) {
        const int64_t kk = k0 + lk;
        st4(&a_re[lk][lc], ld4(br + kk * n1 + m0 + lc));
        st4(&a_im[lk][lc], ld4(bi + kk * n1 + m0 + lc));
        st4(&w_re[lk][lc], ld4(d2 + kk * h2 + n0 + lc));
        st4(&w_im[lk][lc], ld4(d2i + kk * h2 + n0 + lc));
        __syncthreads();
#pragma unroll
        for (int k = 0; k < TK; ++k) {
            float ar[4], ai[4], wr[4], wi[4];
            unpack(*reinterpret_cast<const float4*>(&a_re[k][tm * 4]), ar);
            unpack(*reinterpret_cast<const float4*>(&a_im[k][tm * 4]), ai);
            unpack(*reinterpret_cast<const float4*>(&w_re[k][tn * 4]), wr);
            unpack(*reinterpret_cast<const float4*>(&w_im[k][tn * 4]), wi);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    cr[i][j] = fmaf(ar[i], wr[j], fmaf(-ai[i], wi[j], cr[i][j]));
                    ci[i][j] = fmaf(ar[i], wi[j], fmaf(ai[i], wr[j], ci[i][j]));
                }
        }
        __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int64_t k = (int64_t)(n0 + tn * 4 + j) * n1 + m0 + tm * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            store_bin<MAG>(out, obase + k + i, cr[i][j], ci[i][j]);
    }
}

}  // namespace

extern "C" {

// rfft of `rows` real rows of length n1*n2 (n1 % 64 == 0, n2 % 128 == 0)
// into out (rows, n1*n2/2 + 1): float32 |X| when magnitude != 0, else
// complex64.  b is a (rows, 2, n1*n2) float32 scratch for B; x, the
// tables and b must be 16-byte aligned.  Launches pass 1 then pass 2 on
// `stream`; returns the first nonzero cudaGetLastError() (0 on success).
int rfft_two_pass_launch(const float* x, const float* d1, const float* tw,
                         const float* d2, float* b, void* out, int rows,
                         int n1, int n2, int magnitude, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 g1(rows, n2 / TN, n1 / TM);
    two_pass_stage1<<<g1, THREADS, 0, s>>>(x, d1, tw, b, n1, n2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 g2(rows, n2 / 2 / TN, n1 / TM);
    if (magnitude)
        two_pass_stage2<true><<<g2, THREADS, 0, s>>>(b, d2, out, n1, n2);
    else
        two_pass_stage2<false><<<g2, THREADS, 0, s>>>(b, d2, out, n1, n2);
    return (int)cudaGetLastError();
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
