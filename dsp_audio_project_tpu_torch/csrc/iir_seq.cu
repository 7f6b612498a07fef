// E7: the one-sweep flat EQ for Hopper, a chained scan over blocks, fp32 SIMT.
//
// Replaces the TPU kernel dsp_audio_project_tpu/kernels/experiments/
// iir_seq.py: equalize_seq_flat (body _seq_kernel).  Each row of the flat
// signal is cut into K blocks of G groups of U samples; per block
//
//     inj[g]    = x_g[g] @ group_in                     (G, d)
//     tail[r]   = sum_{v<=r} A^{(r-v)U} inj[v]          the zero-entry group
//                                                       states (the TPU's
//                                                       inj_flat @ toeplitz)
//     s_true[g] = (g ? tail[g-1] : 0) + A^{gU} sigma_k
//     y[g]      = clip(x_g[g] @ fir + s_true[g] @ group_out, -1, 1)
//     sigma_{k+1} = A^block sigma_k + tail[G-1]         carried along the row
//
// with sigma_0 = 0 for every row.  Only the d-vector sigma is sequential.
// The TPU ran the blocks in grid order and kept sigma in VMEM; CUDA blocks
// run in no order, so this kernel is a chained scan: a persistent grid of
// CTAs takes tiles (block k of row r) from an atomic ticket, in the order
// k-major, r-minor, so every tile's predecessor (block k-1 of its row) was
// taken earlier by a CTA that is running or done and never waits on a later
// one.  A CTA computes everything that does not need sigma (x in shared
// memory, inj, tail, the FIR product x_g @ fir), then one thread waits for
// the predecessor's flag, reads sigma_k, publishes sigma_{k+1} and its flag,
// and the CTA finishes the readout and the clip.  The chain's hop is one
// flag round trip through L2 plus d*d multiply-adds.
//
// What bounds it on an H100, at the serving shape (8 rows of 2,949,120
// samples, block 8192, U = 128, G = 64, d = 10: 2880 tiles): about 9.4
// GFLOP, 0.14 ms at the fp32 rate (the FIR product, G*U*U multiply-adds a
// block, is 3/4 of it); its bytes (x read once, y written once, 189 MB)
// take 0.056 ms.  The chain of 360 hops per row is a latency floor of its
// own, and the tables (fir alone is 64 KB) are loaded once per CTA.
//
// Layout: shared memory holds x and the FIR product of one block, fir, the
// G powers A^{gU}, group_in, group_out, A^block and the per-group d-vectors
// (175 KB at the serving shape, one CTA per SM).  The FIR product gives
// each thread 8 groups x 4 columns (float4 loads of fir, x broadcast).
// Requires U % 4 == 0, a 16-byte aligned x and y, d <= 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_D = 16;
constexpr int ROWS_PER_ITEM = 8;        // groups per FIR-product work item

__device__ __forceinline__ int load_acquire(const int* p)
{
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_release(int* p, int v)
{
    asm volatile("st.release.gpu.global.s32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ float clip1(float v)
{
    return fminf(fmaxf(v, -1.f), 1.f);
}

size_t smem_floats(int G, int U, int d)
{
    const size_t block = (size_t)G * U;
    return 2 * block + (size_t)U * U + (size_t)G * d * d + 2 * (size_t)U * d
        + (size_t)d * d + 3 * (size_t)G * d + MAX_D;
}

__global__ void __launch_bounds__(THREADS)
seq_kernel(const float* __restrict__ x, float* __restrict__ y,
           const float* __restrict__ gin, const float* __restrict__ pows,
           const float* __restrict__ fir, const float* __restrict__ gout,
           const float* __restrict__ ablk, float* __restrict__ sig,
           int* __restrict__ sync, int rows, int K, int G, int U, int d)
{
    extern __shared__ __align__(16) float smem[];
    const int B = G * U;
    const int tid = threadIdx.x;
    float* x_s = smem;                    // (G, U)
    float* y_s = x_s + B;                 // (G, U) the FIR product
    float* fir_s = y_s + B;               // (U, U) [v][u]
    float* pows_s = fir_s + U * U;        // (G, d, d) A^{gU}[e][f]
    float* gin_s = pows_s + G * d * d;    // (U, d)
    float* gout_s = gin_s + U * d;        // (d, U)
    float* ablk_s = gout_s + d * U;       // (d, d)
    float* inj_s = ablk_s + d * d;        // (G, d)
    float* tail_s = inj_s + G * d;        // (G, d)
    float* st_s = tail_s + G * d;         // (G, d) s_true
    float* sig_s = st_s + G * d;          // (d) sigma_k
    __shared__ int tile_s;

    for (int i = tid; i < U * U; i += THREADS) fir_s[i] = __ldg(fir + i);
    for (int i = tid; i < G * d * d; i += THREADS) pows_s[i] = __ldg(pows + i);
    for (int i = tid; i < U * d; i += THREADS) {
        gin_s[i] = __ldg(gin + i);
        gout_s[i] = __ldg(gout + i);
    }
    for (int i = tid; i < d * d; i += THREADS) ablk_s[i] = __ldg(ablk + i);

    const int tiles = rows * K;
    const int U4 = U / 4;
    for (;;) {
        __syncthreads();                  // the last tile's reads are done
        if (tid == 0) tile_s = atomicAdd(sync, 1);
        __syncthreads();
        const int t = tile_s;
        if (t >= tiles) break;
        const int k = t / rows;
        const int row = t - k * rows;
        const int64_t base = ((int64_t)row * K + k) * B;

        // 1. x of the block.
        const float4* x4 = reinterpret_cast<const float4*>(x + base);
        for (int i = tid; i < B / 4; i += THREADS)
            reinterpret_cast<float4*>(x_s)[i] = __ldg(x4 + i);
        __syncthreads();

        // 2. inj[g][e] = sum_u x[g][u] group_in[u][e].
        for (int i = tid; i < G * d; i += THREADS) {
            const int g = i / d, e = i - g * d;
            const float* xg = x_s + g * U;
            float acc = 0.f;
            for (int u = 0; u < U; ++u) acc = fmaf(xg[u], gin_s[u * d + e], acc);
            inj_s[i] = acc;
        }
        __syncthreads();

        // 3. tail[r][e] = sum_{v<=r} sum_f A^{(r-v)U}[e][f] inj[v][f].
        for (int i = tid; i < G * d; i += THREADS) {
            const int r = i / d, e = i - r * d;
            float acc = 0.f;
            for (int v = 0; v <= r; ++v) {
                const float* p = pows_s + ((r - v) * d + e) * d;
                const float* iv = inj_s + v * d;
                for (int f = 0; f < d; ++f) acc = fmaf(p[f], iv[f], acc);
            }
            tail_s[i] = acc;
        }
        // 4. The FIR product y0 = x_g @ fir, 8 groups x 4 columns a item.
        const int items = (G + ROWS_PER_ITEM - 1) / ROWS_PER_ITEM * U4;
        for (int it = tid; it < items; it += THREADS) {
            const int c4 = it % U4;
            const int g0 = it / U4 * ROWS_PER_ITEM;
            float4 acc[ROWS_PER_ITEM];
#pragma unroll
            for (int r = 0; r < ROWS_PER_ITEM; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int v = 0; v < U; ++v) {
                const float4 f4 = reinterpret_cast<const float4*>(fir_s + v * U)[c4];
#pragma unroll
                for (int r = 0; r < ROWS_PER_ITEM; ++r) {
                    const float xv = g0 + r < G ? x_s[(g0 + r) * U + v] : 0.f;
                    acc[r].x = fmaf(xv, f4.x, acc[r].x);
                    acc[r].y = fmaf(xv, f4.y, acc[r].y);
                    acc[r].z = fmaf(xv, f4.z, acc[r].z);
                    acc[r].w = fmaf(xv, f4.w, acc[r].w);
                }
            }
#pragma unroll
            for (int r = 0; r < ROWS_PER_ITEM; ++r)
                if (g0 + r < G)
                    reinterpret_cast<float4*>(y_s + (g0 + r) * U)[c4] = acc[r];
        }
        __syncthreads();

        // 5. The chain: sigma_k from the predecessor, sigma_{k+1} published.
        if (tid == 0) {
            if (k == 0) {
                for (int e = 0; e < d; ++e) sig_s[e] = 0.f;
            } else {
                const int* flag = sync + 1 + (int64_t)row * K + k;
                while (load_acquire(flag) == 0) {
                }
                const float* src = sig + ((int64_t)row * K + k) * d;
                for (int e = 0; e < d; ++e) sig_s[e] = __ldcg(src + e);
            }
            if (k + 1 < K) {
                float* dst = sig + ((int64_t)row * K + k + 1) * d;
                for (int e = 0; e < d; ++e) {
                    float acc = tail_s[(G - 1) * d + e];
                    for (int f = 0; f < d; ++f) acc = fmaf(ablk_s[e * d + f], sig_s[f], acc);
                    __stcg(dst + e, acc);
                }
                __threadfence();
                store_release(sync + 1 + (int64_t)row * K + k + 1, 1);
            }
        }
        __syncthreads();

        // 6. s_true[g][e] = (g ? tail[g-1][e] : 0) + A^{gU}[e] . sigma_k.
        for (int i = tid; i < G * d; i += THREADS) {
            const int g = i / d, e = i - g * d;
            const float* p = pows_s + (g * d + e) * d;
            float acc = 0.f;
            for (int f = 0; f < d; ++f) acc = fmaf(p[f], sig_s[f], acc);
            st_s[i] = (g ? tail_s[i - d] : 0.f) + acc;
        }
        __syncthreads();

        // 7. y = clip(y0 + s_true @ group_out), 4 columns a thread.
        float4* y4 = reinterpret_cast<float4*>(y + base);
        for (int i = tid; i < G * U4; i += THREADS) {
            const int g = i / U4, c4 = i - g * U4;
            const float* st = st_s + g * d;
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int e = 0; e < d; ++e) {
                const float sv = st[e];
                const float4 go = reinterpret_cast<const float4*>(gout_s + e * U)[c4];
                acc.x = fmaf(sv, go.x, acc.x);
                acc.y = fmaf(sv, go.y, acc.y);
                acc.z = fmaf(sv, go.z, acc.z);
                acc.w = fmaf(sv, go.w, acc.w);
            }
            const float4 y0 = reinterpret_cast<const float4*>(y_s)[i];
            float4 out;
            out.x = clip1(y0.x + acc.x);
            out.y = clip1(y0.y + acc.y);
            out.z = clip1(y0.z + acc.z);
            out.w = clip1(y0.w + acc.w);
            y4[i] = out;
        }
    }
}

}  // namespace

extern "C" {

// y (rows, K*G*U) from x (rows, K*G*U).  Tables: gin (U, d), pows (G, d, d),
// fir (U, U) = group_fir^T, gout (d, U), ablk (d, d) = A^block, all float32
// contiguous.  Scratch: sig (rows*K*d floats) and sync (1 + rows*K ints,
// zeroed by the caller: the ticket, then one flag per block).  Launches on
// `stream`; returns cudaGetLastError() (0 on success).
int iir_seq_launch(const float* x, float* y, const float* gin,
                   const float* pows, const float* fir, const float* gout,
                   const float* ablk, float* sig, int* sync, int rows, int K,
                   int G, int U, int d, void* stream)
{
    if (U % 4 || d > MAX_D || d < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_floats(G, U, d) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seq_kernel,
                                                        THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long tiles = (long long)rows * K;
    const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
    seq_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        x, y, gin, pows, fir, gout, ablk, sig, sync, rows, K, G, U, d);
    return (int)cudaGetLastError();
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
