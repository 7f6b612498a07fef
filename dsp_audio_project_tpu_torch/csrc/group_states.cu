// The EQ's group-state solve for Hopper on the CUDA cores: the block-lower-
// triangular Toeplitz product of step 2 as a chunked scan, and the entry
// states after the carry, in two launch modes of one source.
//
// Replaces no TPU kernel.  The JAX package leaves this step to XLA as one
// dense product, s_tail = inj @ group_toeplitz
// (dsp_audio_project_tpu/ops/eq.py:106 _grouped_states), and the entry
// states as an einsum, s_true = s_in + A^{gU} sigma (:186); the port ran
// both on cuBLAS (kernels/group_states.py group_states_plain and
// group_entry_states_plain).  At the serving shape (8 x 60 s at 160/147: 1152
// block rows of G = 128 groups, d = 10) that product is 1152 x 1280 by
// 1280 x 1280, 3.78 GFLOP in fp32, though the table is block-lower-
// triangular Toeplitz: block (j, g) = T_{g-j} for j <= g, zero above, so
// half of it multiplies zeros and the rest repeats G taps of d x d.
//
// For a block row with injections inj_g (row vectors) and the taps T_m
// (read from the table's first block row, toe[0:d, m d:(m+1) d]; T_0 = I),
// the zero-entry state after group g is
//
//     s_g = sum_{j <= g} inj_j T_{g-j}.
//
// 1. group_states_gemm_kernel<D, double>: a block a block row, 128 threads,
//    one a group position of a tile of TILE = 128 groups (a loop over
//    tiles covers any G), the tile cut into 32 chunks of CHUNK = 4:
//      A. inside a chunk, thread p = 4 c + i sums its chunk's earlier
//         injections, loc_p = inj_p + sum_{l=1..i} inj_{p-l} T_l (T_0 = I
//         skipped), each tap row read from shared memory as a broadcast
//         16-byte load;
//      B. across the chunks, a Kogge-Stone scan in five barrier-separated
//         steps, a thread an entry (c, e): S_c = loc_{4c+3} (+ carry T_4 at
//         chunk 0), then S_c += S_{c-2^k} T_{4 2^k}, the taps T_4 .. T_64
//         read from the table itself (no power raised), so S_c is the
//         state at the end of chunk c;
//      C. s_p = loc_p + S_{c-1} T_{i+1} (the carry from the last tile at
//         chunk 0), then stored as s_in (shifted by one group, s_in[0] =
//         0) and end = s_{G-1} with coalesced stores; s at the tile's
//         last group is the next tile's carry.
//    The sums run in float64 (the injections and taps are float32,
//    the states rounded to float32 once): where the poles lie close to 1
//    within a group (P = 1 at 11.025 kHz) float32 sums lost ~9 dB against
//    the float64 product and fell below the dense float32 product.
//    Operations a row of G = 128: (192 + 129 + 124) d^2 multiply-adds (the
//    chunks' triangles, the scan, the entering states), 3.5 d^2 a group
//    against the dense product's 64 G d^2.  The injections may be a
//    strided view (the frames route's column slice of [y0 | inj | 0]);
//    each is read once, each output written once: bound by bytes.  The
//    chunk of 4 was the fastest of 1..32 on an H100 (PERF.md, PR 21).
// 2. group_entry_gemm_kernel<D>: s_true = s_in + sigma_k T_g (T_g =
//    group_pows[g]^T, the same table values), a thread a column g d + e
//    of the rows of its block, its d taps in registers; bound by bytes.
//
// Sums run in another order than cuBLAS's, with no tensor cores.  Both names carry "gemm": the benchmark's kernel tables file the
// state solve's device time under one pattern of cuBLAS's names.  No
// atomics, nothing allocated: the launches are captured in a CUDA graph
// as they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;        // one thread a group position
constexpr int TILE = THREADS;       // groups a pass of the block
constexpr int CHUNK = 4;            // groups a chunk
constexpr int CHUNKS = TILE / CHUNK;
constexpr int STEPS = 5;            // log2(CHUNKS): the scan's steps
constexpr int SLOTS = CHUNK + STEPS;   // T_0 .. T_4, then T_8 .. T_64
constexpr int ENTRY_THREADS = 256;

// The tap in slot j: T_j for j <= CHUNK, then T_{CHUNK 2^k}, k = 1..4.
__host__ __device__ constexpr int tap_of(int j)
{
    return j <= CHUNK ? j : CHUNK << (j - CHUNK);
}

template <int D>
struct Layout {
    static constexpr int TS = D * D;             // a tap (doubles; rows 16-byte aligned, D even)
    static constexpr int GS = D + 1;             // a group in shared memory (odd: no bank conflicts)
};

// v += a * (a tap row), the row read as 16-byte pairs of doubles.
template <int D>
__device__ __forceinline__ void add_tap_row(double (&v)[D], double a, const double* row)
{
#pragma unroll
    for (int e = 0; e < D; e += 2) {
        const double2 w = reinterpret_cast<const double2*>(row)[e / 2];
        v[e] = fma(a, w.x, v[e]);
        v[e + 1] = fma(a, w.y, v[e + 1]);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
group_states_gemm_kernel(const float* __restrict__ inj,
                         const float* __restrict__ toe,
                         float* __restrict__ s_in, float* __restrict__ end,
                         int rows, int K, int G, long long so, long long sk,
                         long long sg, long long ldt)
{
    constexpr int TS = Layout<D>::TS, GS = Layout<D>::GS, RS = D;
    __shared__ __align__(16) double taps[SLOTS * TS];
    // The injections until A has read them, then the scan's two buffers
    // (2 x 32 D double fit in 128 (D + 1) floats).
    __shared__ __align__(16) float inj_s[TILE * GS];
    __shared__ double loc_s[TILE * GS];
    __shared__ double carry_s[D];               // the state before the tile
    double* const scan_s[2] = {reinterpret_cast<double*>(inj_s),
                               reinterpret_cast<double*>(inj_s) + CHUNKS * D};
    const int tid = threadIdx.x, row = blockIdx.x;
    {   // every tap load in flight before the first store
        constexpr int N = (SLOTS * TS + THREADS - 1) / THREADS;
        float v[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            const int i = tid + k * THREADS;
            const int m = tap_of(i / TS), f = (i % TS) / RS, e = i % RS;
            v[k] = (i < SLOTS * TS && e < D && m < G)
                ? __ldg(toe + f * ldt + (long long)m * D + e) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < N; ++k)
            if (tid + k * THREADS < SLOTS * TS) taps[tid + k * THREADS] = v[k];
    }
    if (tid < D) carry_s[tid] = 0.0;
    const long long base = (long long)(row / K) * so + (long long)(row % K) * sk;
    const long long o = (long long)row * G * D;
    const int p = tid, m = p / CHUNK, pi = p % CHUNK;

    static_assert(2 * CHUNKS * D * sizeof(double) <= TILE * (D + 1) * sizeof(float),
                  "the scan's buffers overlay the injections");
    for (int t0 = 0; t0 < G; t0 += TILE) {
        const int nt = min(TILE, G - t0);
        {   // D loads a thread, all in flight before the first store
            float v[D];
#pragma unroll
            for (int k = 0; k < D; ++k) {
                const int i = tid + k * THREADS, q = i / D, e = i % D;
                v[k] = q < nt ? __ldg(inj + base + (long long)(t0 + q) * sg + e) : 0.f;
            }
#pragma unroll
            for (int k = 0; k < D; ++k) {
                const int i = tid + k * THREADS;
                inj_s[(i / D) * GS + i % D] = v[k];
            }
        }
        __syncthreads();

        // A: the chunk's lower triangle of taps.
        {
            double acc[D];
#pragma unroll
            for (int e = 0; e < D; ++e) acc[e] = inj_s[p * GS + e];
            for (int l = 1; l <= pi; ++l) {
#pragma unroll
                for (int f = 0; f < D; ++f)
                    add_tap_row<D>(acc, inj_s[(p - l) * GS + f],
                                   taps + l * TS + f * RS);
            }
#pragma unroll
            for (int e = 0; e < D; ++e) loc_s[p * GS + e] = acc[e];
        }
        __syncthreads();   // A has read inj_s: the scan may overwrite it

        // B: the scan over the chunks' ends, S_c = loc_{4c+3} (+ carry T_4
        // at chunk 0), then S_c += S_{c-2^k} T_{4 2^k}: a thread an entry
        // (c, e), a barrier a step.
        for (int i = tid; i < CHUNKS * D; i += THREADS) {
            const int c = i / D, e = i % D;
            double v = loc_s[(c * CHUNK + CHUNK - 1) * GS + e];
            if (c == 0) {
#pragma unroll
                for (int f = 0; f < D; ++f) v += carry_s[f] * taps[CHUNK * TS + f * RS + e];
            }
            scan_s[0][i] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < STEPS; ++k) {
            const double* src = scan_s[k & 1];
            double* dst = scan_s[(k + 1) & 1];
            const double* T = taps + (k ? CHUNK + k : CHUNK) * TS;
            for (int i = tid; i < CHUNKS * D; i += THREADS) {
                const int c = i / D, e = i % D;
                double v = src[i];
                if (c >= (1 << k)) {
                    const double* prev = src + (c - (1 << k)) * D;
#pragma unroll
                    for (int f = 0; f < D; ++f) v += prev[f] * T[f * RS + e];
                }
                dst[i] = v;
            }
            __syncthreads();
        }
        const double* S = scan_s[STEPS & 1];

        // C: each position takes the state entering its chunk.
        {
            const double* rv = m ? S + (m - 1) * D : carry_s;
            double* lp = loc_s + p * GS;
            double acc[D];
#pragma unroll
            for (int e = 0; e < D; ++e) acc[e] = lp[e];
#pragma unroll
            for (int f = 0; f < D; ++f)
                add_tap_row<D>(acc, rv[f], taps + (pi + 1) * TS + f * RS);
#pragma unroll
            for (int e = 0; e < D; ++e) lp[e] = acc[e];
        }
        __syncthreads();

        // Store: s_in[g + 1] = s_g, end = s_{G-1}, s_in[0] = 0.
        for (int i = tid; i < TILE * D; i += THREADS) {
            const int q = i / D, e = i % D, g = t0 + q;
            if (q >= nt) continue;
            const float v = (float)loc_s[q * GS + e];
            if (g + 1 < G) s_in[o + (long long)(g + 1) * D + e] = v;
            else end[(long long)row * D + e] = v;
            if (g == 0) s_in[o + e] = 0.f;
        }
        if (t0 + TILE < G && tid < D) carry_s[tid] = loc_s[(TILE - 1) * GS + tid];
        // The next tile's load rewrites inj_s (the scan's buffers, last
        // read in C, before the barrier above); loc_s and carry_s are read
        // again only after its barrier.
    }
}

template <int D>
__global__ void __launch_bounds__(ENTRY_THREADS)
group_entry_gemm_kernel(const float* __restrict__ s_in,
                        const float* __restrict__ sigma,
                        const float* __restrict__ toe,
                        float* __restrict__ s_true, int rows, int GD,
                        long long ldt, int rows_a_block)
{
    const int q = blockIdx.x * ENTRY_THREADS + threadIdx.x;  // g d + e
    if (q >= GD) return;
    float t[D];
#pragma unroll
    for (int f = 0; f < D; ++f) t[f] = __ldg(toe + f * ldt + q);
    for (int r0 = blockIdx.y * rows_a_block; r0 < rows;
         r0 += gridDim.y * rows_a_block) {
        const int r1 = min(rows, r0 + rows_a_block);
#pragma unroll 4
        for (int r = r0; r < r1; ++r) {
            const float* sv = sigma + (long long)r * D;
            float acc = 0.f;
#pragma unroll
            for (int f = 0; f < D; ++f) acc = fmaf(__ldg(sv + f), t[f], acc);
            const long long o = (long long)r * GD + q;
            s_true[o] = __ldg(s_in + o) + acc;
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

template <int D>
int launch_states(const float* inj, const float* toe, float* s_in, float* end,
                  int rows, int K, int G, long long so, long long sk,
                  long long sg, long long ldt, cudaStream_t stream)
{
    group_states_gemm_kernel<D><<<rows, THREADS, 0, stream>>>(
        inj, toe, s_in, end, rows, K, G, so, sk, sg, ldt);
    return (int)cudaGetLastError();
}

template <int D>
int launch_entry(const float* s_in, const float* sigma, const float* toe,
                 float* s_true, int rows, int G, long long ldt,
                 cudaStream_t stream)
{
    const int GD = G * D;
    const int cols = (GD + ENTRY_THREADS - 1) / ENTRY_THREADS;
    // About four blocks an SM, at most 32 rows a block.
    long long per = (long long)rows * cols / (4LL * sm_count());
    const int rows_a_block = (int)(per < 1 ? 1 : (per > 32 ? 32 : per));
    const int chunks = (rows + rows_a_block - 1) / rows_a_block;
    const int by = chunks < 65535 ? chunks : 65535;
    group_entry_gemm_kernel<D><<<dim3(cols, by), ENTRY_THREADS, 0, stream>>>(
        s_in, sigma, toe, s_true, rows, GD, ldt, rows_a_block);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Zero-entry group states of rows = outer x K block rows: inj at
// inj + (row / K) so + (row % K) sk + g sg + e (floats), the taps from
// toe's first d rows (row stride ldt, unit column stride), s_in (rows, G, d)
// and end (rows, d) contiguous; d even in 2..16.  Returns
// cudaGetLastError() (0 on success).
int group_states_launch(const float* inj, const float* toe, float* s_in,
                        float* end, int rows, int K, int G, int d,
                        long long so, long long sk, long long sg,
                        long long ldt, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d) {
    case 2: return launch_states<2>(inj, toe, s_in, end, rows, K, G, so, sk, sg, ldt, s);
    case 4: return launch_states<4>(inj, toe, s_in, end, rows, K, G, so, sk, sg, ldt, s);
    case 6: return launch_states<6>(inj, toe, s_in, end, rows, K, G, so, sk, sg, ldt, s);
    case 8: return launch_states<8>(inj, toe, s_in, end, rows, K, G, so, sk, sg, ldt, s);
    case 10: return launch_states<10>(inj, toe, s_in, end, rows, K, G, so, sk, sg, ldt, s);
    case 12: return launch_states<12>(inj, toe, s_in, end, rows, K, G, so, sk, sg, ldt, s);
    case 14: return launch_states<14>(inj, toe, s_in, end, rows, K, G, so, sk, sg, ldt, s);
    case 16: return launch_states<16>(inj, toe, s_in, end, rows, K, G, so, sk, sg, ldt, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// s_true = s_in + sigma T_g over rows block rows: s_in and s_true (rows,
// G, d), sigma (rows, d), all contiguous; the taps from toe's first d rows.
int group_entry_launch(const float* s_in, const float* sigma, const float* toe,
                       float* s_true, int rows, int G, int d, long long ldt,
                       void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d) {
    case 2: return launch_entry<2>(s_in, sigma, toe, s_true, rows, G, ldt, s);
    case 4: return launch_entry<4>(s_in, sigma, toe, s_true, rows, G, ldt, s);
    case 6: return launch_entry<6>(s_in, sigma, toe, s_true, rows, G, ldt, s);
    case 8: return launch_entry<8>(s_in, sigma, toe, s_true, rows, G, ldt, s);
    case 10: return launch_entry<10>(s_in, sigma, toe, s_true, rows, G, ldt, s);
    case 12: return launch_entry<12>(s_in, sigma, toe, s_true, rows, G, ldt, s);
    case 14: return launch_entry<14>(s_in, sigma, toe, s_true, rows, G, ldt, s);
    case 16: return launch_entry<16>(s_in, sigma, toe, s_true, rows, G, ldt, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
