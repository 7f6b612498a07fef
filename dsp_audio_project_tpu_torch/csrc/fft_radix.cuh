// Register-radix Stockham FFT building blocks for Hopper (fp32 SIMT), shared
// by K2 (csrc/rfft_four_step.cu) and K7/K8 (csrc/rfft_two_pass.cu); the
// plain torch mirror is kernels/fft_radix.py.
//
// A complex FFT of nh = 2^L points runs as passes(L) = ceil(L/4) Stockham
// passes of radix R = 2^pass_bits(L, p) <= 16 (the bits spread as evenly as
// they go: 1024 = 16 * 8 * 8, 4096 = 16 * 16 * 16).  Each thread holds E
// values in registers, E/R butterflies of a pass; butterfly j of a pass
// with span NS (the product of the earlier radices) reads elements
// j + r * nh/R, multiplies input r by W_{NS R}^{r (j mod NS)} (one fp32
// table of W_nh^m, m < nh, built in float64 on the host, read through L1),
// runs an R-point DFT in registers (log2 R radix-2 stages on compile-time
// constants) and writes output r to (j / NS) * NS * R + (j mod NS) + r * NS:
// the output is in natural order after the last pass, with no bit
// reversal.  Between passes the values go once through shared memory, as
// two fp32 planes at swizzled addresses a + (a >> 5) (one pad word every
// 32), which keeps the strided stores of the early passes on distinct
// banks.
//
// The real input is packed, z[m] = x[2m] + i x[2m+1] (N = 2 nh real
// points), and the packed-real untwiddle is fused into the store:
//   X[k]      = E + W_N^k O,   X[nh - k] = conj(E - W_N^k O),
//   E = (Z[k] + conj Z[nh-k]) / 2,  O = -i (Z[k] - conj Z[nh-k]) / 2,
// for k = 0 .. nh/2 (Z[nh] = Z[0]), with W_N^k from a second table of
// nh/2 + 1 entries; |X| is fused into the magnitude store.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fft_radix {

__host__ __device__ constexpr int passes(int L) { return (L + 3) / 4; }

__host__ __device__ constexpr int pass_bits(int L, int p)
{
    return L / passes(L) + (p < L % passes(L) ? 1 : 0);
}

__host__ __device__ constexpr int pass_shift(int L, int p)
{
    int s = 0;
    for (int q = 0; q < p; ++q) s += pass_bits(L, q);
    return s;
}

__host__ __device__ constexpr int bit_reverse(int i, int bits)
{
    int r = 0;
    for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
    return r;
}

__device__ __forceinline__ int swz(int a) { return a + (a >> 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b)
{
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * W_16^q (q folds to a constant once the DFT loops are unrolled).
__device__ __forceinline__ float2 rot16(float2 a, int q)
{
    constexpr float C1 = 0.92387953251128674f;   // cos(pi/8)
    constexpr float S1 = 0.38268343236508978f;   // sin(pi/8)
    constexpr float R2 = 0.70710678118654752f;   // sqrt(1/2)
    switch (q) {
    case 0: return a;
    case 1: return cmul(a, make_float2(C1, -S1));
    case 2: return cmul(a, make_float2(R2, -R2));
    case 3: return cmul(a, make_float2(S1, -C1));
    case 4: return make_float2(a.y, -a.x);
    case 5: return cmul(a, make_float2(-S1, -C1));
    case 6: return cmul(a, make_float2(-R2, -R2));
    default: return cmul(a, make_float2(-C1, -S1));
    }
}

// Radix-2 stage of span H of the in-register R-point DFT of v[OFF ..
// OFF + R), then the rest.  Template recursion keeps every index a
// constant, so v stays in registers.
template <int R, int H, int OFF, int E>
__device__ __forceinline__ void dft_stages(float2 (&v)[E])
{
#pragma unroll
    for (int s = 0; s < R; s += 2 * H)
#pragma unroll
        for (int m = 0; m < H; ++m) {
            const float2 a = v[OFF + s + m];
            const float2 t = rot16(v[OFF + s + m + H], m * (8 / H));
            v[OFF + s + m] = make_float2(a.x + t.x, a.y + t.y);
            v[OFF + s + m + H] = make_float2(a.x - t.x, a.y - t.y);
        }
    if constexpr (2 * H < R) dft_stages<R, 2 * H, OFF>(v);
}

// The bit-reversal permutation of v[OFF .. OFF + R), one swap at a time
// (each index a constant expression: a reversal computed at run time
// would send v to local memory).
template <int R, int B, int OFF, int I, int E>
__device__ __forceinline__ void bit_reverse_swaps(float2 (&v)[E])
{
    if constexpr (I < R) {
        constexpr int J = bit_reverse(I, B);
        if constexpr (I < J) {
            const float2 s = v[OFF + I];
            v[OFF + I] = v[OFF + J];
            v[OFF + J] = s;
        }
        bit_reverse_swaps<R, B, OFF, I + 1>(v);
    }
}

// In-register R-point DFT (R = 2, 4, 8, 16) of v[OFF .. OFF + R), natural
// order in and out.
template <int R, int OFF, int E>
__device__ __forceinline__ void dft(float2 (&v)[E])
{
    constexpr int B = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
    static_assert((1 << B) == R, "radix must be 2, 4, 8 or 16");
    bit_reverse_swaps<R, B, OFF, 0>(v);
    dft_stages<R, 1, OFF>(v);
}

// Pass p of the plan of an nh = 2^L point FFT, E values a thread:
// v[q R + r] is input r of butterfly j = t + q TPR.
template <int L, int E, int P>
struct Stage {
    static constexpr int NH = 1 << L;
    static constexpr int LR = pass_bits(L, P), LS = pass_shift(L, P);
    static constexpr int R = 1 << LR, NS = 1 << LS;
    static constexpr int T = NH / R, TPR = NH / E, BF = E / R;
    static constexpr bool LAST = P + 1 == passes(L);
    static_assert(E % R == 0, "a thread holds whole butterflies");

    static __device__ __forceinline__ int in(int t, int q, int r) { return t + q * TPR + r * T; }

    static __device__ __forceinline__ int out(int t, int q, int r)
    {
        const int j = t + q * TPR;
        return ((j >> LS) << (LS + LR)) + (j & (NS - 1)) + r * NS;
    }

    // Twiddles (none in pass 0) and the R-point DFT of butterflies Q..
    // BF-1.  tw is W_M^m with M = NH * stride: a sub-FFT of a larger
    // transform reads every stride-th entry.
    template <int Q = 0>
    static __device__ __forceinline__ void butterflies(
        float2 (&v)[E], int t, const float2* __restrict__ tw, int stride)
    {
        if constexpr (Q < BF) {
            if constexpr (P > 0) {
                const int k = (t + Q * TPR) & (NS - 1);
                const int step = k * (NH / (NS * R)) * stride;
#pragma unroll
                for (int r = 1; r < R; ++r)
                    v[Q * R + r] = cmul(v[Q * R + r], __ldg(tw + r * step));
            }
            dft<R, Q * R>(v);
            butterflies<Q + 1>(v, t, tw, stride);
        }
    }
};

template <int L, int E>
using LastStage = Stage<L, E, passes(L) - 1>;

// Runs passes P.. on v (pass P's inputs), the exchange between passes
// through shared memory by st(i, value) / ld(i).  On return v holds the
// last pass's outputs, element LastStage::out(t, q, r) in v[q R + r].
// Every thread of the block must call it (it holds barriers).
template <int L, int E, int P, class Ld, class St>
__device__ __forceinline__ void run_passes(float2 (&v)[E], int t,
                                           const float2* __restrict__ tw,
                                           int stride, Ld ld, St st)
{
    using S = Stage<L, E, P>;
    S::butterflies(v, t, tw, stride);
    if constexpr (!S::LAST) {
        using N = Stage<L, E, P + 1>;
#pragma unroll
        for (int q = 0; q < S::BF; ++q)
#pragma unroll
            for (int r = 0; r < S::R; ++r) st(S::out(t, q, r), v[q * S::R + r]);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < N::BF; ++q)
#pragma unroll
            for (int r = 0; r < N::R; ++r) v[q * N::R + r] = ld(N::in(t, q, r));
        __syncthreads();
        run_passes<L, E, P + 1>(v, t, tw, stride, ld, st);
    }
}

// The packed-real untwiddle of the pair (k, nh - k): a = Z[k],
// b = Z[nh - k], w = W_N^k; xk = X[k], xm = X[nh - k].
__device__ __forceinline__ void untwiddle(float2 a, float2 b, float2 w,
                                          float2& xk, float2& xm)
{
    const float er = 0.5f * (a.x + b.x), ei = 0.5f * (a.y - b.y);
    const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
    const float2 wo = cmul(w, o);
    xk = make_float2(er + wo.x, ei + wo.y);
    xm = make_float2(er - wo.x, wo.y - ei);
}

template <bool MAG>
__device__ __forceinline__ void store_bin(void* out, int64_t i, float2 v)
{
    if constexpr (MAG)
        static_cast<float*>(out)[i] = sqrtf(v.x * v.x + v.y * v.y);
    else
        static_cast<float2*>(out)[i] = v;
}

// ---- one row in shared memory: K2 (N <= 8192) and K7 up to N = 32768 ------

template <int L, int E>
struct RowShape {
    static constexpr int NH = 1 << L, TPR = NH / E;
    static constexpr int THREADS = TPR < 256 ? 256 : TPR;
    static constexpr int RPC = THREADS / TPR;          // rows per block
    static constexpr int PLANE = RPC * NH + ((RPC * NH) >> 5);
    static constexpr size_t SMEM = 2 * (size_t)PLANE * sizeof(float);
};

// rfft of `rows` real rows of N = 2^(L+1) points (z: the rows as packed
// complex pairs, 8-byte aligned) into out (rows, N/2 + 1): |X| (MAG) or
// complex64.  Block b holds rows b*RPC .. b*RPC + RPC - 1.
template <int L, int E, bool MAG>
__global__ void __launch_bounds__(RowShape<L, E>::THREADS)
rfft_rows_kernel(const float2* __restrict__ z, void* __restrict__ out,
                 const float2* __restrict__ tw, const float2* __restrict__ un,
                 int64_t rows)
{
    using S = RowShape<L, E>;
    using F = Stage<L, E, 0>;
    using La = LastStage<L, E>;
    extern __shared__ float smem[];
    float* sre = smem;
    float* sim = smem + S::PLANE;
    const int lr = threadIdx.x / S::TPR, t = threadIdx.x % S::TPR;
    const int64_t row = (int64_t)blockIdx.x * S::RPC + lr;
    const bool live = row < rows;
    const int base = lr * S::NH;
    auto ld = [&](int i) {
        const int a = swz(base + i);
        return make_float2(sre[a], sim[a]);
    };
    auto st = [&](int i, float2 v) {
        const int a = swz(base + i);
        sre[a] = v.x;
        sim[a] = v.y;
    };

    float2 v[E];
    const float2* zr = z + (live ? row : 0) * S::NH;
#pragma unroll
    for (int q = 0; q < F::BF; ++q)
#pragma unroll
        for (int r = 0; r < F::R; ++r)
            v[q * F::R + r] = live ? __ldg(zr + F::in(t, q, r))
                                   : make_float2(0.f, 0.f);
    run_passes<L, E, 0>(v, t, tw, 1, ld, st);
#pragma unroll
    for (int q = 0; q < La::BF; ++q)
#pragma unroll
        for (int r = 0; r < La::R; ++r) st(La::out(t, q, r), v[q * La::R + r]);
    __syncthreads();
    if (!live) return;

    const int64_t ob = row * (S::NH + 1);
    for (int k = t; k <= S::NH / 2; k += S::TPR) {
        float2 xk, xm;
        untwiddle(ld(k), ld((S::NH - k) & (S::NH - 1)), __ldg(un + k), xk, xm);
        store_bin<MAG>(out, ob + k, xk);
        if (k != S::NH / 2) store_bin<MAG>(out, ob + S::NH - k, xm);
    }
}

template <int L, int E, bool MAG>
int launch_rows(const float* x, void* out, const float* tw, const float* un,
                int64_t rows, cudaStream_t stream)
{
    using S = RowShape<L, E>;
    if (S::SMEM > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            rfft_rows_kernel<L, E, MAG>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
        if (err != cudaSuccess) return (int)err;
    }
    const int64_t grid = (rows + S::RPC - 1) / S::RPC;
    rfft_rows_kernel<L, E, MAG><<<(unsigned)grid, S::THREADS, S::SMEM, stream>>>(
        reinterpret_cast<const float2*>(x), out,
        reinterpret_cast<const float2*>(tw), reinterpret_cast<const float2*>(un),
        rows);
    return (int)cudaGetLastError();
}

}  // namespace fft_radix
