// K9: the EQ finish epilogue for Hopper, fp32 SIMT.
//
// Replaces the TPU kernel dsp_audio_project_tpu/kernels/eq_finish.py:
// eq_finish_pallas (body _finish_kernel).  Over rows r (frames, or EQ
// groups of U samples, with every leading axis folded into r) it computes
//
//     z[r, :] = clip(y0[r, :] + sum_e s_true[r, e] * group_out[e, :], -1, 1)
//
// y0 (rows, U) with row stride ldy (it may be a column slice of the EQ's
// weight-concat product), s_true (rows, d) contiguous in its natural
// layout, group_out (d, U), z (rows, U) contiguous.  The TPU kernel's
// packed-transposed s_true (st[b, k, dd*128 + g]) exists only so that
// Mosaic can relayout it; here a row's d states are d consecutive floats.
//
// What bounds it on an H100, at the serving shape (batch 8 x 60 s at
// 48 kHz: 147,456 rows of U = 160, d = 10): it reads y0 (94.4 MB) and
// s_true (5.9 MB) and writes z (94.4 MB), about 0.058 ms at 3.35 TB/s; its
// 0.47 G multiply-adds are negligible.  It is bound by memory.
//
// Design: group_out (d x U floats, under 24 KB for d <= 12 and U <= 480)
// sits in shared memory, loaded once per block.  Blocks walk tiles of ROWS
// rows (a grid-stride loop over about 8 blocks per SM); for each tile the
// block stages the tile's ROWS x d states in shared memory with one
// coalesced load, so every row's states are read from memory once.  Each
// thread then owns 4 consecutive output columns of a row (16-byte loads of
// y0 and stores of z) where U, ldy and both pointers allow it, else one
// column (scalar path; L/M = 441/480 gives U = 441).  The readout sums the
// d products first and adds y0 last, as the plain version y0 + s @ gout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 32;            // rows per tile
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ float clip1(float v)
{
    return fminf(fmaxf(v, -1.f), 1.f);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
eq_finish_kernel(const float* __restrict__ y0, const float* __restrict__ st,
                 const float* __restrict__ gout, float* __restrict__ z,
                 int rows, int U, int d, int ldy)
{
    extern __shared__ __align__(16) float smem[];
    float* g_s = smem;                  // (d, U)
    float* s_s = smem + d * U;          // (ROWS, d)
    for (int i = threadIdx.x; i < d * U; i += THREADS) g_s[i] = gout[i];

    const int per_row = VEC ? U / 4 : U;     // work items per row
    const int tiles = (rows + ROWS - 1) / ROWS;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r0 = t * ROWS;
        const int nr = min(ROWS, rows - r0);
        __syncthreads();                // g_s loaded; last tile's s_s read
        for (int i = threadIdx.x; i < nr * d; i += THREADS)
            s_s[i] = __ldg(st + (int64_t)r0 * d + i);
        __syncthreads();
        for (int i = threadIdx.x; i < nr * per_row; i += THREADS) {
            const int r = i / per_row;
            const int c = i - r * per_row;
            const float* sr = s_s + r * d;
            const int64_t row = r0 + r;
            if (VEC) {
                float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
                for (int e = 0; e < d; ++e) {
                    const float sv = sr[e];
                    const float4 g = reinterpret_cast<const float4*>(g_s + e * U)[c];
                    acc.x = fmaf(sv, g.x, acc.x);
                    acc.y = fmaf(sv, g.y, acc.y);
                    acc.z = fmaf(sv, g.z, acc.z);
                    acc.w = fmaf(sv, g.w, acc.w);
                }
                const float4 y = __ldg(reinterpret_cast<const float4*>(y0 + row * ldy) + c);
                float4 out;
                out.x = clip1(y.x + acc.x);
                out.y = clip1(y.y + acc.y);
                out.z = clip1(y.z + acc.z);
                out.w = clip1(y.w + acc.w);
                reinterpret_cast<float4*>(z + row * U)[c] = out;
            } else {
                float acc = 0.f;
                for (int e = 0; e < d; ++e) acc = fmaf(sr[e], g_s[e * U + c], acc);
                z[row * U + c] = clip1(__ldg(y0 + row * ldy + c) + acc);
            }
        }
    }
}

int sm_count()
{
    static int cached[64] = {0};
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    if (dev >= 0 && dev < 64 && cached[dev]) return cached[dev];
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (dev >= 0 && dev < 64) cached[dev] = sms;
    return sms;
}

template <bool VEC>
int launch(const float* y0, const float* st, const float* gout, float* z,
           int rows, int U, int d, int ldy, cudaStream_t stream)
{
    const size_t smem = (size_t)(d * U + ROWS * d) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            eq_finish_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int sms = sm_count();
    const int tiles = (rows + ROWS - 1) / ROWS;
    const int grid = tiles < sms * BLOCKS_PER_SM ? tiles : sms * BLOCKS_PER_SM;
    eq_finish_kernel<VEC><<<grid, THREADS, smem, stream>>>(
        y0, st, gout, z, rows, U, d, ldy);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `vec`
// selects the 16-byte path: the caller guarantees U % 4 == 0,
// ldy % 4 == 0 and 16-byte aligned y0 and z.
int eq_finish_launch(const float* y0, const float* st, const float* gout,
                     float* z, int rows, int U, int d, int ldy, int vec,
                     void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return vec ? launch<true>(y0, st, gout, z, rows, U, d, ldy, s)
               : launch<false>(y0, st, gout, z, rows, U, d, ldy, s);
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
