// K2: batched rfft of real rows, four-step, for Hopper (fp32 SIMT).
//
// Replaces the TPU kernel dsp_audio_project_tpu/kernels/rfft.py:
// rfft_pallas_four_step (body _four_step_kernel), both forms: |X| (the
// spectrum op) and complex X (the STFT).  For each real row x of length
// N = n1 * n2 (a power of two, 256..8192):
//
//   step 1 (column DFT + twiddle, n1^2 FMAs per j2):
//       B[k1, j2] = sum_j1 x[j1*n2 + j2] * C[k1, j1, j2]
//   step 2 (row DFT, half spectrum only):
//       X[k1 + n1*k2] = sum_j2 B[k1, j2] * W_n2^{j2*k2}
//   step 3: out[k] = |X[k]| (MAG) or X[k] as an interleaved (re, im)
//           float2 (the layout of complex64), for k = 0 .. N/2.
//
// C = W_n1^{k1 j1} * W_n^{k1 j2} and the row-DFT matrix d2 = [Re | Im]
// W_n2^{j2 k2} are the JAX package's host tables (_four_step_tables,
// float64 -> f32).  They stay in global memory (c is 256 KB and d2 128 KB
// at N = 2048, too much for one block) and are read through L1/L2; every
// block reads the same tables.
//
// What bounds it on an H100: about 0.6 M FMAs per 2048-point row.  The
// serving chain runs 24 rows, so its launch is bound by latency; the STFT
// runs 41344 rows (8 signals x 5168 frames), ~50 GFLOP, bound by the FMAs
// and by the table reads through L1 that feed them.  Design: a (row, slice) grid; each block
// stages its row (N floats) and computes all of B (2 x n1 x (n2+1) floats,
// rows padded by one to keep the step-2 reads of different k1 on different
// banks) in shared memory, then the step-2 bins of its slice.  Step 1 is
// about a tenth of step 2's work, so repeating it per slice is cheap, and
// the slices spread a small batch (24 rows) over the card's SMs.
// Step 1 maps consecutive threads to consecutive j2 (coalesced table reads,
// conflict-free row reads); step 2 maps consecutive threads to consecutive
// k2 of one k1, so the d2 reads are coalesced and the B reads broadcast.
// Sums are plain fp32 FMAs (the TPU kernel's bf16x3 row DFT is at most as
// accurate).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool MAG>
__global__ void __launch_bounds__(THREADS)
rfft_four_step_kernel(const float* __restrict__ x, const float* __restrict__ c,
                      const float* __restrict__ d2, void* __restrict__ out,
                      int n, int n1)
{
    extern __shared__ float smem[];
    const int n2 = n / n1;
    const int ld = n2 + 1;                  // padded row stride of B
    float* xs = smem;                       // n
    float* br = xs + n;                     // n1 * ld
    float* bi = br + n1 * ld;               // n1 * ld

    const int row = blockIdx.x;
    const float* xr = x + (int64_t)row * n;
    for (int i = threadIdx.x; i < n; i += THREADS) xs[i] = __ldg(xr + i);
    __syncthreads();

    // Step 1: column DFT over j1 with the twiddle folded into C.
    const int nn = n1 * n1;
    for (int o = threadIdx.x; o < n; o += THREADS) {
        const int k1 = o / n2;
        const int j2 = o - k1 * n2;
        const float* cr = c + ((int64_t)k1 * n1) * n2 + j2;
        const float* ci = cr + (int64_t)nn * n2;
        float ar = 0.f, ai = 0.f;
        for (int j1 = 0; j1 < n1; ++j1) {
            const float xv = xs[j1 * n2 + j2];
            ar = fmaf(xv, __ldg(cr + (int64_t)j1 * n2), ar);
            ai = fmaf(xv, __ldg(ci + (int64_t)j1 * n2), ai);
        }
        br[k1 * ld + j2] = ar;
        bi[k1 * ld + j2] = ai;
    }
    __syncthreads();

    // Step 2: row DFT for the bins k = k1 + n1*k2 <= n/2 only, this
    // block's slice [o_lo, o_hi) of the (k1, k2) grid.
    const int half = n / 2;
    const int k2n = n2 / 2 + 1;
    const int total = n1 * k2n;
    const int per = (total + gridDim.y - 1) / gridDim.y;
    const int o_lo = blockIdx.y * per;
    const int o_hi = min(total, o_lo + per);
    const int64_t obase = (int64_t)row * (half + 1);
    for (int o = o_lo + threadIdx.x; o < o_hi; o += THREADS) {
        const int k1 = o / k2n;
        const int k2 = o - k1 * k2n;
        const int k = k1 + n1 * k2;
        if (k > half) continue;
        const float* bre = br + k1 * ld;
        const float* bim = bi + k1 * ld;
        float xr_ = 0.f, xi_ = 0.f;
        for (int j2 = 0; j2 < n2; ++j2) {
            const float dr = __ldg(d2 + (int64_t)j2 * 2 * n2 + k2);
            const float di = __ldg(d2 + (int64_t)j2 * 2 * n2 + n2 + k2);
            const float a = bre[j2];
            const float b = bim[j2];
            xr_ = fmaf(a, dr, fmaf(-b, di, xr_));
            xi_ = fmaf(a, di, fmaf(b, dr, xi_));
        }
        if constexpr (MAG)
            static_cast<float*>(out)[obase + k] = sqrtf(xr_ * xr_ + xi_ * xi_);
        else
            static_cast<float2*>(out)[obase + k] = make_float2(xr_, xi_);
    }
}

size_t smem_bytes(int n, int n1)
{
    return sizeof(float) * ((size_t)n + 2 * (size_t)n1 * (n / n1 + 1));
}

template <bool MAG>
int launch(const float* x, const float* c, const float* d2, void* out,
           int rows, int n, int n1, void* stream)
{
    const size_t smem = smem_bytes(n, n1);
    cudaError_t err = cudaFuncSetAttribute(
        rfft_four_step_kernel<MAG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    // Slices per row: enough blocks to cover the SMs twice, at most 8 (1
    // from 264 rows up).  Rows ride grid.x, which holds 2^31 - 1.
    int slices = rows >= 2 * sms ? 1 : (2 * sms + rows - 1) / rows;
    slices = slices > 8 ? 8 : slices;
    const dim3 grid(rows, slices);
    rfft_four_step_kernel<MAG>
        <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
            x, c, d2, out, n, n1);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// |rfft| of `rows` rows of length n into out (rows, n/2+1) float32;
// returns cudaGetLastError() (0 on success).
int rfft_mag_launch(const float* x, const float* c, const float* d2,
                    float* out, int rows, int n, int n1, void* stream)
{
    return launch<true>(x, c, d2, out, rows, n, n1, stream);
}

// rfft of `rows` rows of length n into out (rows, n/2+1) complex64, as
// interleaved (re, im) floats; returns cudaGetLastError().
int rfft_complex_launch(const float* x, const float* c, const float* d2,
                        float* out, int rows, int n, int n1, void* stream)
{
    return launch<false>(x, c, d2, out, rows, n, n1, stream);
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
