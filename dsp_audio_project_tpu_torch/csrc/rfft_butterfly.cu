// E6: the radix-2 butterfly rfft of real rows for Hopper, fp32 SIMT.
//
// Replaces the TPU kernel dsp_audio_project_tpu/kernels/experiments/
// rfft_butterfly.py: rfft_pallas (body _fft_stages_kernel).  For a real row
// x of N = 2*nh points (nh a power of two, N <= 32768):
//
//   1. pack z[m] = x[2m] + i x[2m+1] and store it bit-reversed;
//   2. log2(nh) radix-2 stages in place: for span h, a = z[i], b = z[i+h],
//      t = W^pos b with W^pos = e^{-i pi pos / h}; z[i] = a + t,
//      z[i+h] = a - t;
//   3. the packed-real untwiddle, fused into the store (the JAX code left
//      it outside its kernel only because Mosaic could not reverse lanes):
//      X[k] = (Z[k] + conj Z[nh-k]) / 2 + e^{-2 pi i k / N} (Z[k] -
//      conj Z[nh-k]) / (2i), k = 0..nh, Z[nh] = Z[0].
//
// What bounds it on an H100, at the STFT's frames (41344 rows of 2048): it
// reads 339 MB and writes 339 MB of complex64, 0.2023 ms at 3.35 TB/s; its
// 2.5 N log2 N flops a row (2.3 GFLOP) take 0.034 ms at the fp32 rate.  It
// is bound by memory, as far as its shared-memory traffic (log2 nh passes
// over the row, each behind a __syncthreads) lets it be.
//
// Design: a CTA holds one row (or 1024/nh rows when nh < 1024) in shared
// memory as two planes, real and imaginary.  Stage twiddles come from one
// table W_nh^k (k < nh/2, float64 cast once), stage s reading every
// nh/2^(s+1)-th entry; the untwiddle from a second table of nh+1 entries.
// The bit-reversed stores of step 1 would put a warp's 32 values in one
// bank; shared addresses are swizzled, p ^ (top 5 bits of p), which keeps
// runs of 32 consecutive positions on 32 banks and spreads the bit-reversed
// ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int ROW_FLOATS = 1024;        // a CTA holds max(nh, 1024) complex

__device__ __forceinline__ int swz(int p, int L)
{
    return L >= 10 ? p ^ ((p >> (L - 5)) & 31) : p;
}

__global__ void __launch_bounds__(THREADS)
butterfly_kernel(const float* __restrict__ x, float2* __restrict__ out,
                 const float2* __restrict__ tw, const float2* __restrict__ un,
                 int rows, int L, int rpc)
{
    extern __shared__ __align__(16) float smem[];
    const int nh = 1 << L;
    const int r0 = blockIdx.x * rpc;
    const int nr = min(rpc, rows - r0);
    float* zr = smem;                   // (rpc, nh), swizzled within a row
    float* zi = smem + rpc * nh;

    // 1. Pack and bit-reverse.
    for (int i = threadIdx.x; i < nr * nh; i += THREADS) {
        const int r = i >> L, m = i & (nh - 1);
        const float2 v = __ldg(reinterpret_cast<const float2*>(
            x + (int64_t)(r0 + r) * 2 * nh) + m);
        const int p = r * nh + swz(L ? (int)(__brev((unsigned)m) >> (32 - L)) : 0, L);
        zr[p] = v.x;
        zi[p] = v.y;
    }
    __syncthreads();

    // 2. The radix-2 stages.
    const int hb = nh >> 1;             // butterflies per row
    for (int s = 0; s < L; ++s) {
        const int half = 1 << s;
        for (int b = threadIdx.x; b < nr * hb; b += THREADS) {
            const int r = b >> (L - 1);
            const int q = b & (hb - 1);
            const int pos = q & (half - 1);
            const int i = ((q >> s) << (s + 1)) + pos;
            const float2 w = __ldg(tw + (pos << (L - 1 - s)));
            const int pi = r * nh + swz(i, L);
            const int pj = r * nh + swz(i + half, L);
            const float br = zr[pj], bi = zi[pj];
            const float tr = br * w.x - bi * w.y;
            const float ti = br * w.y + bi * w.x;
            const float ar = zr[pi], ai = zi[pi];
            zr[pi] = ar + tr;
            zi[pi] = ai + ti;
            zr[pj] = ar - tr;
            zi[pj] = ai - ti;
        }
        __syncthreads();
    }

    // 3. The packed-real untwiddle, into the store.
    const int nb = nh + 1;
    for (int i = threadIdx.x; i < nr * nb; i += THREADS) {
        const int r = i / nb, k = i - r * nb;
        const int pa = r * nh + swz(k == nh ? 0 : k, L);
        const int pb = r * nh + swz(k == 0 ? 0 : nh - k, L);
        const float zkr = zr[pa], zki = zi[pa];
        const float cr = zr[pb], ci = -zi[pb];          // conj Z[nh - k]
        const float er = 0.5f * (zkr + cr), ei = 0.5f * (zki + ci);
        const float dr = zkr - cr, di = zki - ci;
        const float odr = 0.5f * di, odi = -0.5f * dr;  // -i/2 (Z[k] - conj)
        const float2 u = __ldg(un + k);
        out[(int64_t)(r0 + r) * nb + k] =
            make_float2(er + (u.x * odr - u.y * odi), ei + (u.x * odi + u.y * odr));
    }
}

}  // namespace

extern "C" {

// out (rows, N/2+1) complex64 as interleaved floats, from x (rows, N)
// float32 (8-byte aligned rows), N = 2^(L+1) with 1 <= L <= 14.  tw: nh/2
// complex64 W_nh^k; un: nh+1 complex64 e^{-2 pi i k / N}.  Launches on
// `stream`; returns cudaGetLastError() (0 on success).
int rfft_butterfly_launch(const float* x, float* out, const float* tw,
                          const float* un, int rows, int L, void* stream)
{
    if (L < 1 || L > 14) return (int)cudaErrorInvalidValue;
    const int nh = 1 << L;
    const int rpc = nh < ROW_FLOATS ? ROW_FLOATS / nh : 1;
    const size_t smem = 2 * (size_t)rpc * nh * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            butterfly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int grid = (rows + rpc - 1) / rpc;
    butterfly_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        x, reinterpret_cast<float2*>(out), reinterpret_cast<const float2*>(tw),
        reinterpret_cast<const float2*>(un), rows, L, rpc);
    return (int)cudaGetLastError();
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
