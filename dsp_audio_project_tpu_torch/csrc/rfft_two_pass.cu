// K7 and K8: batched rfft of real rows for N = 16384 .. 1048576 as
// register-radix FFTs for Hopper (fp32 SIMT).
//
// Replaces the TPU kernels dsp_audio_project_tpu/kernels/rfft.py:
// rfft_pallas_four_step_tall (K7, N = 16384..524288) and
// rfft_pallas_two_level (K8, N = 1048576); both are the launcher
// rfft_two_pass_launch.  Outputs (rows, N/2 + 1): |X| or complex64 X as
// interleaved (re, im) floats.
//
// What bounds it on an H100: bytes.  The input is read once and X written
// once; an fp32 FFT's ~2.5 N log2 N flops a row take a fraction of that
// time at the SIMT rate.  The row is packed as nh = N/2 complex points,
// z[m] = x[2m] + i x[2m+1], as in K2 (csrc/fft_radix.cuh).
//
// N <= 32768: one pass.  A row of nh <= 16384 complex (<= 132 KB of fp32
// planes) lives in shared memory and runs K2's body: ceil(log2(nh)/4)
// Stockham passes of radix <= 16 in registers (8192 = 16 * 8 * 8 * 8,
// 16384 = 16 * 16 * 8 * 8), 32 values a thread, one exchange between
// passes, the untwiddle and |X| fused into the store.  This is the
// spectrogram's N = 16384 (a 256-thread block a row, so that two rows
// share an SM's registers where 16 values on 512 threads fit one) and the
// long spectra's 32768.
//
// N >= 65536: two passes through global memory on nh = n1 * n2 with
// n2 = 2^floor(log2(nh)/2) <= 512 and n1 = nh/n2 <= 1024, j = j1 n2 + j2,
// k = k1 + n1 k2:
//   pass 1: for each column j2, the n1-point FFT over j1, times the
//     twiddle W_nh^(k1 j2) (two entries of the W_nh table, W^(m mod 1024)
//     W^(m - m mod 1024), for nh > 1024), stored as B[k1, j2].  A block
//     takes G >= 8 consecutive columns, so every global read and write is
//     a run of >= 64 contiguous bytes; the last register pass writes B
//     directly.
//   pass 2: for each row k1, the n2-point FFT over j2 of B[k1, :].  A
//     block holds G consecutive rows k1 and their mirror rows n1 - k1,
//     whose bins pair up: nh - (k1 + n1 k2) = (n1 - k1) + n1 (n2-1-k2).  So
//     the untwiddle is fused into pass 2's store, and the k-ordered stores
//     of X[k] and X[nh-k] are runs of G bins.  Row 0 pairs with itself
//     under k2 -> n2 - k2 (the Nyquist bin X[nh] comes from Z[0]); row
//     n1/2 pairs with itself under k2 -> n2-1-k2 and rides in block 0 in
//     the slot of row 0's mirror.
// B is complex nh per row (the wrapper's (rows, N) float32 scratch); at
// N = 2^20 each pass moves about 4 N bytes a row in and out.

#include "fft_radix.cuh"

namespace {

using fft_radix::cmul;
using fft_radix::LastStage;
using fft_radix::run_passes;
using fft_radix::Stage;
using fft_radix::store_bin;
using fft_radix::swz;
using fft_radix::untwiddle;

constexpr int E = 16;    // values a thread in the two-pass kernels

// W_nh^m for m < nh from the W_nh table: one entry up to nh = 1024, else
// the product of two (m = hi + lo, lo < 1024), both read through L1.
template <int L>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw, int m)
{
    if constexpr (L <= 10)
        return __ldg(tw + m);
    else
        return cmul(__ldg(tw + (m & 1023)), __ldg(tw + (m & ~1023)));
}

template <int L, int L1>
struct ColShape {
    static constexpr int NH = 1 << L, N1 = 1 << L1, N2 = NH / N1;
    static constexpr int TPC = N1 / E;                       // threads a column
    static constexpr int G = (4096 >> L1) > 8 ? (4096 >> L1) : 8;
    static constexpr int THREADS = G * TPC, TILES = N2 / G;
    static constexpr int PLANE = G * N1 + ((G * N1) >> 5);
    static constexpr size_t SMEM = 2 * (size_t)PLANE * sizeof(float);
};

// Pass 1.  Block b: row b / TILES, columns (b % TILES) * G + c, c < G.
template <int L, int L1>
__global__ void __launch_bounds__(ColShape<L, L1>::THREADS)
two_pass_columns(const float2* __restrict__ z, float2* __restrict__ bout,
                 const float2* __restrict__ tw)
{
    using S = ColShape<L, L1>;
    using F = Stage<L1, E, 0>;
    using La = LastStage<L1, E>;
    extern __shared__ float smem[];
    float* sre = smem;
    float* sim = smem + S::PLANE;
    const int c = threadIdx.x % S::G, t = threadIdx.x / S::G;
    const int64_t row = blockIdx.x / S::TILES;
    const int j2 = (blockIdx.x % S::TILES) * S::G + c;
    auto ld = [&](int i) {
        const int a = swz(i * S::G + c);
        return make_float2(sre[a], sim[a]);
    };
    auto st = [&](int i, float2 v) {
        const int a = swz(i * S::G + c);
        sre[a] = v.x;
        sim[a] = v.y;
    };

    float2 v[E];
    const float2* zr = z + row * S::NH + j2;
#pragma unroll
    for (int q = 0; q < F::BF; ++q)
#pragma unroll
        for (int r = 0; r < F::R; ++r)
            v[q * F::R + r] = __ldg(zr + (int64_t)F::in(t, q, r) * S::N2);
    run_passes<L1, E, 0>(v, t, tw, S::N2, ld, st);
    float2* br = bout + row * S::NH + j2;
#pragma unroll
    for (int q = 0; q < La::BF; ++q)
#pragma unroll
        for (int r = 0; r < La::R; ++r) {
            const int k1 = La::out(t, q, r);
            br[(int64_t)k1 * S::N2] = cmul(v[q * La::R + r], twiddle<L>(tw, k1 * j2));
        }
}

template <int L, int L2>
struct RowPairShape {
    static constexpr int NH = 1 << L, N2 = 1 << L2, N1 = NH / N2;
    static constexpr int TPR = N2 / E;                       // threads a row
    static constexpr int G = (2048 >> L2) > 8 ? (2048 >> L2) : 8;
    static constexpr int SLOTS = 2 * G, THREADS = SLOTS * TPR;
    static constexpr int TILES = N1 / (2 * G);
    static constexpr int PLANE = SLOTS * N2 + ((SLOTS * N2) >> 5) + SLOTS;
    static constexpr size_t SMEM = 2 * (size_t)PLANE * sizeof(float);
    static_assert(TILES >= 1, "n1 must hold two tiles of rows");
};

// Pass 2.  Block b: row b / TILES, tile p = b % TILES: slots g < G hold B
// rows k1 = p G + g, slots G + g their mirrors n1 - k1 (slot G of tile 0:
// row n1/2).  Writes X[k] and X[nh - k] for every k whose k1 is in the
// tile, and tile 0 also those of row n1/2.
template <int L, int L2, bool MAG>
__global__ void __launch_bounds__(RowPairShape<L, L2>::THREADS)
two_pass_rows(const float2* __restrict__ b, void* __restrict__ out,
              const float2* __restrict__ tw, const float2* __restrict__ un)
{
    using S = RowPairShape<L, L2>;
    using F = Stage<L2, E, 0>;
    using La = LastStage<L2, E>;
    extern __shared__ float smem[];
    float* sre = smem;
    float* sim = smem + S::PLANE;
    const int64_t row = blockIdx.x / S::TILES;
    const int p = blockIdx.x % S::TILES;
    const int slot = threadIdx.x / S::TPR, t = threadIdx.x % S::TPR;
    int k1;
    if (slot < S::G) {
        k1 = p * S::G + slot;
    } else {
        const int g = slot - S::G;
        k1 = (p == 0 && g == 0) ? S::N1 / 2 : S::N1 - (p * S::G + g);
    }
    auto at = [](int s, int i) { return swz(s * S::N2 + i) + s; };
    auto ld = [&](int i) {
        const int a = at(slot, i);
        return make_float2(sre[a], sim[a]);
    };
    auto st = [&](int i, float2 v) {
        const int a = at(slot, i);
        sre[a] = v.x;
        sim[a] = v.y;
    };

    float2 v[E];
    const float2* br = b + row * S::NH + (int64_t)k1 * S::N2;
#pragma unroll
    for (int q = 0; q < F::BF; ++q)
#pragma unroll
        for (int r = 0; r < F::R; ++r)
            v[q * F::R + r] = __ldg(br + F::in(t, q, r));
    run_passes<L2, E, 0>(v, t, tw, S::N1, ld, st);
#pragma unroll
    for (int q = 0; q < La::BF; ++q)
#pragma unroll
        for (int r = 0; r < La::R; ++r) st(La::out(t, q, r), v[q * La::R + r]);
    __syncthreads();

    auto z_at = [&](int s, int i) {
        const int a = at(s, i);
        return make_float2(sre[a], sim[a]);
    };
    const int64_t ob = row * (S::NH + 1);
    // The pair (k, nh - k) from its canonical side kk = min(k, nh - k).
    auto put = [&](int k, float2 zk, float2 zm) {
        float2 xa, xb;
        if (k <= S::NH / 2) {
            untwiddle(zk, zm, __ldg(un + k), xa, xb);
        } else {
            k = S::NH - k;
            untwiddle(zm, zk, __ldg(un + k), xa, xb);
        }
        store_bin<MAG>(out, ob + k, xa);
        if (k != S::NH / 2) store_bin<MAG>(out, ob + S::NH - k, xb);
    };
    for (int idx = threadIdx.x; idx < S::G * S::N2; idx += S::THREADS) {
        const int g = idx % S::G, k2 = idx / S::G;
        const int kr = p * S::G + g;
        const int k = kr + S::N1 * k2;
        if (kr == 0) {
            if (k > S::NH / 2) continue;       // row 0's pairs, once each
            put(k, z_at(0, k2), z_at(0, (S::N2 - k2) & (S::N2 - 1)));
        } else {
            put(k, z_at(g, k2), z_at(S::G + g, S::N2 - 1 - k2));
        }
    }
    if (p == 0)
        for (int k2 = threadIdx.x; k2 < S::N2 / 2; k2 += S::THREADS)
            put(S::N1 / 2 + S::N1 * k2, z_at(S::G, k2),
                z_at(S::G, S::N2 - 1 - k2));
}

template <class K>
int allow_smem(K kernel, size_t bytes)
{
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int L, int L2, bool MAG>
int launch_two_pass(const float* x, const float* tw, const float* un,
                    float* b, void* out, int64_t rows, cudaStream_t s)
{
    constexpr int L1 = L - L2;
    using C = ColShape<L, L1>;
    using R = RowPairShape<L, L2>;
    int err = allow_smem(two_pass_columns<L, L1>, C::SMEM);
    if (err) return err;
    err = allow_smem(two_pass_rows<L, L2, MAG>, R::SMEM);
    if (err) return err;
    const float2* tw2 = reinterpret_cast<const float2*>(tw);
    two_pass_columns<L, L1><<<(unsigned)(rows * C::TILES), C::THREADS, C::SMEM, s>>>(
        reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(b), tw2);
    err = (int)cudaGetLastError();
    if (err) return err;
    two_pass_rows<L, L2, MAG><<<(unsigned)(rows * R::TILES), R::THREADS, R::SMEM, s>>>(
        reinterpret_cast<const float2*>(b), out, tw2,
        reinterpret_cast<const float2*>(un));
    return (int)cudaGetLastError();
}

template <bool MAG>
int launch(const float* x, const float* tw, const float* un, float* b,
           void* out, int64_t rows, int n, cudaStream_t s)
{
    using fft_radix::launch_rows;
    switch (n) {
    case 16384: return launch_rows<13, 32, MAG>(x, out, tw, un, rows, s);
    case 32768: return launch_rows<14, 32, MAG>(x, out, tw, un, rows, s);
    case 65536: return launch_two_pass<15, 7, MAG>(x, tw, un, b, out, rows, s);
    case 131072: return launch_two_pass<16, 8, MAG>(x, tw, un, b, out, rows, s);
    case 262144: return launch_two_pass<17, 8, MAG>(x, tw, un, b, out, rows, s);
    case 524288: return launch_two_pass<18, 9, MAG>(x, tw, un, b, out, rows, s);
    case 1048576: return launch_two_pass<19, 9, MAG>(x, tw, un, b, out, rows, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// rfft of `rows` real rows of length n (a power of two in 16384..1048576;
// x 8-byte aligned) into out (rows, n/2 + 1): float32 |X| when magnitude
// != 0, else complex64.  tw: n/2 complex64 W_{n/2}^m; un: n/4 + 1
// complex64 e^{-2 pi i k / n}; b: a (rows, n) float32 scratch for B (not
// read for n <= 32768, which runs one pass).  Launches on `stream`;
// returns the first nonzero cudaGetLastError() (0 on success).
int rfft_two_pass_launch(const float* x, const float* tw, const float* un,
                         float* b, void* out, int rows, int n, int magnitude,
                         void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return magnitude ? launch<true>(x, tw, un, b, out, rows, n, s)
                     : launch<false>(x, tw, un, b, out, rows, n, s);
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
