// E2a and E2b: the block-parallel IIR recurrence for Hopper, fp32 SIMT.
//
// Replaces the TPU kernels dsp_audio_project_tpu/kernels/experiments/iir.py:
// block_end_states (E2a, body _end_state_kernel) and block_apply (E2b, body
// _apply_kernel).  The signal is cut into chains (every leading axis and the
// block axis K folded together) of B samples each; the EQ cascade's order-d
// state-space system (s <- s A^T + x_j B, y_j = s . C + D x_j) runs along
// each chain:
//
//     E2a  end_states[ch] = the state after B steps from a zero state
//     E2b  y[ch, j]       = the outputs of B steps from the true initial
//                           state sigma[ch] (solved between the two kernels)
//
// What bounds it on an H100, at the serving shape (batch 8 x 60 s at 48 kHz,
// block 8192: 2816 chains of 8192 steps, d = 10): each step is d*d + d
// multiply-adds (E2b: + d + 1 for the output), 5.1 GFLOP for E2a, about
// 0.076 ms at the fp32 rate; its bytes (92 MB of x) take 0.028 ms.  But a
// chain's steps are sequential: the kernels are bound by the latency and
// instruction throughput of 8192 dependent steps, several times the
// operation bound.
//
// Design: a segment of 16 lanes runs one chain, lane e holding the state
// component s[e] and row e of A (and B[e]) in registers; lanes e >= d hold
// zeros.  A step writes the components to shared memory and reads all d
// back as float4s (one store and d/4 loads, where d shuffles cost more:
// the shuffle unit serves one warp-instruction a clock per SM), then takes
// two interleaved d/2-deep multiply-add chains; 2816 chains give 1408 warps
// (about 11 an SM) to hide the dependent path.  x comes in 64-byte
// coalesced loads of 16 samples (lane l loads sample j0 + l, the next tile
// prefetched) and is broadcast one sample a step; in E2b every lane forms
// y_j = s . C + D x_j from the state it has read (C in the constant bank),
// lane j mod 16 keeps it, and the segment stores 16 samples at a time.  d
// is a template parameter (the even orders 2..12: one biquad band adds 2
// states).  One thread a chain (88 warps, A in the constant bank) measured
// about 2x slower at the serving shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 12;
constexpr int SEG = 16;                 // lanes per chain
constexpr int THREADS = 128;            // 8 chains per block
constexpr unsigned FULL = 0xffffffffu;

struct System {                 // row-major A, then B, C, D (float32)
    float a[MAX_D * MAX_D];     // a[e * MAX_D + f] = A[e][f]
    float b[MAX_D];
    float c[MAX_D];
    float d;
};

template <int D, bool APPLY>
__global__ void __launch_bounds__(THREADS)
iir_kernel(const float* __restrict__ x, const float* __restrict__ sigma,
           float* __restrict__ out, const System sys, int chains, int B)
{
    constexpr int DV = (D + 3) / 4;      // float4s holding the state
    // Each chain's state, double-buffered so that one __syncwarp a step
    // orders every write before the reads and the next write.
    __shared__ __align__(16) float st[2][THREADS / SEG][SEG];
    const int lane = threadIdx.x & (SEG - 1);
    const int slot = threadIdx.x / SEG;
    const int64_t ch = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / SEG;
    const bool live = ch < chains;       // both segments of a warp take part
    const bool own = lane < D;
    const int e = own ? lane : 0;
    float a[D];
#pragma unroll
    for (int f = 0; f < D; ++f) a[f] = own ? sys.a[e * MAX_D + f] : 0.f;
    const float b = own ? sys.b[e] : 0.f;
    const float* xr = x + (live ? ch : 0) * (int64_t)B;
    float s = (APPLY && live && own) ? __ldg(sigma + ch * D + lane) : 0.f;

    int buf = 0;
    float xv = (live && lane < B) ? __ldg(xr + lane) : 0.f;
    for (int j0 = 0; j0 < B; j0 += SEG) {
        const int n = min(SEG, B - j0);                  // uniform
        const float xnext = (live && j0 + SEG + lane < B)
            ? __ldg(xr + j0 + SEG + lane) : 0.f;
        float yv = 0.f;
#pragma unroll 4
        for (int jj = 0; jj < n; ++jj) {
            const float xj = __shfl_sync(FULL, xv, jj, SEG);
            st[buf][slot][lane] = s;
            __syncwarp();
            float sv[4 * DV];
#pragma unroll
            for (int q = 0; q < DV; ++q) {
                const float4 v = reinterpret_cast<const float4*>(st[buf][slot])[q];
                sv[4 * q] = v.x;
                sv[4 * q + 1] = v.y;
                sv[4 * q + 2] = v.z;
                sv[4 * q + 3] = v.w;
            }
            buf ^= 1;
            if (APPLY) {            // y_j = s . C + D x_j, before the step
                float t = 0.f;
#pragma unroll
                for (int f = 0; f < D; ++f) t = fmaf(sv[f], sys.c[f], t);
                const float yj = fmaf(sys.d, xj, t);
                if (lane == jj) yv = yj;
            }
            float s0 = xj * b, s1 = 0.f;   // s <- A s + B x_j, row `lane`
#pragma unroll
            for (int f = 0; f < D; f += 2) {
                s0 = fmaf(a[f], sv[f], s0);
                s1 = fmaf(a[f + 1], sv[f + 1], s1);
            }
            s = s0 + s1;
        }
        if (APPLY && live && lane < n) out[ch * (int64_t)B + j0 + lane] = yv;
        xv = xnext;
    }
    if (!APPLY && live && own) out[ch * D + lane] = s;
}

// consts: HOST array [A (d*d, row-major) | B (d) | C (d) | D (1)].
System make_system(const float* consts, int d)
{
    System sys = {};
    for (int e = 0; e < d; ++e)
        for (int f = 0; f < d; ++f) sys.a[e * MAX_D + f] = consts[e * d + f];
    for (int e = 0; e < d; ++e) {
        sys.b[e] = consts[d * d + e];
        sys.c[e] = consts[d * d + d + e];
    }
    sys.d = consts[d * d + 2 * d];
    return sys;
}

template <int D>
int launch_d(bool apply, const float* x, const float* sigma, float* out,
             const System& sys, int chains, int B, cudaStream_t stream)
{
    const int64_t threads = (int64_t)chains * SEG;
    const int grid = (int)((threads + THREADS - 1) / THREADS);
    if (apply)
        iir_kernel<D, true><<<grid, THREADS, 0, stream>>>(x, sigma, out, sys, chains, B);
    else
        iir_kernel<D, false><<<grid, THREADS, 0, stream>>>(x, sigma, out, sys, chains, B);
    return (int)cudaGetLastError();
}

int launch(bool apply, const float* x, const float* sigma, float* out,
           const float* consts, int chains, int B, int d, cudaStream_t stream)
{
    if ((int64_t)chains * SEG / THREADS >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const System sys = make_system(consts, d);
    switch (d) {
    case 2:  return launch_d<2>(apply, x, sigma, out, sys, chains, B, stream);
    case 4:  return launch_d<4>(apply, x, sigma, out, sys, chains, B, stream);
    case 6:  return launch_d<6>(apply, x, sigma, out, sys, chains, B, stream);
    case 8:  return launch_d<8>(apply, x, sigma, out, sys, chains, B, stream);
    case 10: return launch_d<10>(apply, x, sigma, out, sys, chains, B, stream);
    case 12: return launch_d<12>(apply, x, sigma, out, sys, chains, B, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// E2a: end[ch, :] (chains, d) from x (chains, B).  `consts` is a host
// array (see make_system).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int iir_end_states_launch(const float* x, float* end, const float* consts,
                          int chains, int B, int d, void* stream)
{
    return launch(false, x, nullptr, end, consts, chains, B, d,
                  static_cast<cudaStream_t>(stream));
}

// E2b: y (chains, B) from x (chains, B) and sigma (chains, d).
int iir_apply_launch(const float* x, const float* sigma, float* y,
                     const float* consts, int chains, int B, int d,
                     void* stream)
{
    return launch(true, x, sigma, y, consts, chains, B, d,
                  static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
