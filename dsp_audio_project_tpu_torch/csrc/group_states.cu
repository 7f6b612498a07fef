// The EQ's state solve for Hopper on the CUDA cores: the block-lower-
// triangular Toeplitz product of step 2, the carry across blocks and the
// entry states, as two kernels of one source (and, for the callers that
// run the carry themselves, the zero-seed form and the entry kernel).
//
// Replaces no TPU kernel.  The JAX package leaves the state solve to XLA:
// the zero-entry states as one dense product, s_tail = inj @
// group_toeplitz (dsp_audio_project_tpu/ops/eq.py:106 _grouped_states),
// the carry as one matmul against a triangle of powers (:568
// _carry_states) and the entry states as an einsum, s_true = s_in +
// A^{gU} sigma (:186).  The port's plain versions run the same three on
// cuBLAS (kernels/group_states.py group_solve_plain).  At the serving
// shape (8 x 60 s at 160/147: 1152 block rows of G = 128 groups, K = 144
// blocks a signal, d = 10) the dense product is 3.78 GFLOP of fp32 though
// the table is block-lower-triangular Toeplitz (block (j, g) = T_{g-j} for
// j <= g, zero above), and the carry's triangle `carry_w` (8.29 MB) is
// half zeros and repeats K powers.
//
// For a block row with injections inj_g (row vectors) and the taps T_m
// (the table's first block row, toe[0:d, m d:(m+1) d]; T_0 = I), the
// state after group g, entering the block with state sigma, is
//
//     s_g = sigma T_{g+1} + sum_{j <= g} inj_j T_{g-j},
//
// and the blocks' entering states follow from the zero-entry ends e_i =
// s_{G-1}(sigma = 0) of the earlier blocks of the same signal,
//
//     sigma_k = sigma0 C_k + sum_{i < k} e_i C_{k-1-i},
//
// with C_m = (A^{block m})^T from `carry_w`'s first block row, carry_w[0:d,
// m d:(m+1) d] (ops/eq.py _carry_weights and the dynamic builder's
// _lower_triangle lay it out so).
//
// A warp owns a block row and lane l chunk l of CHUNK = 4 groups of a
// tile of TILE = 128 groups (a loop over tiles covers any G).  A block of
// WARPS = 4 warps stages the taps it shares with cp.async (float32) and
// widens them to float64 in shared memory; a warp's tile of injections
// lands in its own buffer by 8-byte cp.async (a strided view is taken as
// it is), each chunk at an odd stride of 8-byte words, so that the lanes
// read their chunks without bank conflicts.  A tap past the table is zero,
// and only ever multiplies a zero state.
//
// 1. group_ends_gemm_kernel<D>: each lane sums its chunk's end, inj_3 +
//    inj_2 T_1 + inj_1 T_2 + inj_0 T_3; the earlier tiles' state enters at
//    lane 0 (T_4); a Kogge-Stone scan over the lanes by __shfl_up_sync,
//    S_l += S_{l-2^k} T_{4 2^k}, k = 0..4, leaves in lane l the zero-entry
//    state after the chunk: written as pre[row][c] for the solve, and the
//    row's end e (inside the last chunk where 4 does not divide G).
// 2. group_solve_gemm_kernel<D, CARRY>: CARRY: warp 0 sums the block's
//    sigmas from (1)'s ends, staged in shared memory: the first row's by a
//    tree (lane l takes the n = ceil(K / 32) blocks m in (k - n (32 - l),
//    k - n (31 - l)], sum_i v_{top-i} C_i with v_0 = sigma0, v_m = e_{m-1},
//    then the lane scan with C_{n 2^k}), each next row's as sigma_{k+1} =
//    sigma_k C_1 + e_k; without CARRY the seed is zero (the split callers
//    carry between two launches).  The state entering lane l's chunk is
//    pre[l-1] plus the seed's share, seed T_{4 l} (each lane its own tap,
//    staged; the seed itself at lane 0); then each group s = s T_1 + inj,
//    stored over the injection it read and written out as coalesced
//    8-byte stores, shifted by one group: out[0] = seed, out[g + 1] = s_g
//    (CARRY: s_true, and sigma; else s_in).
// 3. group_entry_gemm_kernel<D>: s_true = s_in + sigma T_g for the split
//    callers, a thread a column g d + e, float32.
// All sums of (1) and (2) run in float64 from the float32 injections and
// taps (float32 sums of a scan lost ~9 dB where the poles lie close to 1
// within a group, PERF.md), rounded to float32 once.  At the serving
// shape (1) reads the injections (5.90 MB) and writes pre (1.47 MB), 8 d^2
// multiply-adds a lane; (2) reads them again with pre and writes s_true
// (5.90 MB), 5 d^2 a lane and the carry's 12 d^2 a block: bound by bytes
// (20.6 MB at 3.35 TB/s against ~0.12 GFLOP at 34 TFLOP/s of float64), but
// a lone wave of 288 blocks pays each warp's chain of latencies.
//
// Names carry "gemm" and no template argument is a float64 type: the
// benchmark's kernel tables file the state solve's device time by name.
// No atomics, nothing allocated: the launches are captured in a CUDA graph
// as they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;            // block rows a block, a warp each
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 4;            // groups a lane
constexpr int TILE = 32 * CHUNK;    // groups a warp's pass
constexpr int STEPS = 5;            // log2(32): the scan's steps
constexpr int ESLOTS = CHUNK + STEPS - 1;   // ends: T_1 .. T_4, T_8 .. T_64
constexpr unsigned FULL = 0xffffffffu;
constexpr int ENTRY_THREADS = 256;

// Tap index of ends slot j: T_{j+1} for j < CHUNK, then T_{4 2^k}.
__host__ __device__ constexpr int ends_tap(int j)
{
    return j < CHUNK ? j + 1 : CHUNK << (j - CHUNK + 1);
}

// Tap index of carry slot j at chunk n: C_{j+1} for j < n - 1, then
// C_{n 2^k}, k = 0..4 (C_1 at slot 0 for every n).
__host__ __device__ constexpr int carry_tap(int j, int n)
{
    return j < n - 1 ? j + 1 : n << (j - n + 1);
}

template <int D>
struct Shape {
    static constexpr int TS = D * D + 2;      // a tap (padded: odd in 8-byte
                                              // words, the lanes' own taps
                                              // conflict-free)
    static constexpr int H = D / 2;           // 8-byte words a group
    static constexpr int CS = CHUNK * D + 2;  // floats a chunk in a tile: odd in words
    static constexpr int WS = 32 * CS;        // floats a tile
    static constexpr int WF = WS + 2 * D;     // floats a warp: its tile, one state
};

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8-byte copy, or zero fill when !ok (src is then not read).
__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool ok)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v += a T, T float64 in shared memory (rows of D, each 16-byte pair read
// as a broadcast).
template <int D>
__device__ __forceinline__ void add_product(double (&v)[D], const double (&a)[D],
                                            const double* T)
{
#pragma unroll
    for (int f = 0; f < D; ++f) {
#pragma unroll
        for (int e = 0; e < D; e += 2) {
            const double2 w = reinterpret_cast<const double2*>(T + f * D)[e / 2];
            v[e] = fma(a[f], w.x, v[e]);
            v[e + 1] = fma(a[f], w.y, v[e + 1]);
        }
    }
}

// v += a T, T float32 in shared memory (a lane's own tap).
template <int D>
__device__ __forceinline__ void add_product_f32(double (&v)[D], const double (&a)[D],
                                                const float* T)
{
#pragma unroll
    for (int f = 0; f < D; ++f) {
#pragma unroll
        for (int e = 0; e < D; e += 2) {
            const float2 w = reinterpret_cast<const float2*>(T + f * D)[e / 2];
            v[e] = fma(a[f], (double)w.x, v[e]);
            v[e + 1] = fma(a[f], (double)w.y, v[e + 1]);
        }
    }
}

// v = the D floats at p, or zero where !ok.
template <int D>
__device__ __forceinline__ void read_vec(double (&v)[D], const float* p, bool ok = true)
{
#pragma unroll
    for (int e = 0; e < D; e += 2) {
        const float2 w = ok ? reinterpret_cast<const float2*>(p)[e / 2]
                            : make_float2(0.f, 0.f);
        v[e] = w.x;
        v[e + 1] = w.y;
    }
}

// v += the D floats at p, times T (a group's injection times a tap).
template <int D>
__device__ __forceinline__ void add_group(double (&v)[D], const float* p,
                                          const double* T)
{
    double a[D];
    read_vec<D>(a, p);
    add_product<D>(v, a, T);
}

// Copy `slots` taps of a first block row (row stride ld; slot j holds tap
// index tap(j), zero at or past `avail`) into stage[j TS + f D + e]
// (float32), by cp.async over the block's threads.
template <int D, typename Tap>
__device__ __forceinline__ void copy_taps(float* stage, const float* src,
                                          long long ld, int slots, int avail,
                                          Tap tap)
{
    constexpr int TS = Shape<D>::TS, H = Shape<D>::H;
    for (int i = threadIdx.x; i < slots * D * H; i += THREADS) {
        const int j = i / (D * H), r = i % (D * H), f = r / H;
        const int e = 2 * (r % H), m = tap(j);
        const bool ok = m < avail;
        cp_async8(stage + j * TS + f * D + e,
                  ok ? src + f * ld + (long long)m * D + e : src, ok);
    }
}

// Every thread's copies but its newest group (the first tile) landed,
// then the taps widened to float64.
__device__ __forceinline__ void widen_taps(double* taps, const float* stage,
                                           int n)
{
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += THREADS) taps[i] = stage[i];
    __syncthreads();
}

// A row's tile of TILE groups from t0 (groups past G zero) into the warp's
// buffer, chunk c at c CS, by cp.async; committed, not waited for.
template <int D>
__device__ __forceinline__ void load_tile(float* buf, const float* inj,
                                          long long base, long long sg,
                                          int t0, int G)
{
    constexpr int H = Shape<D>::H, CS = Shape<D>::CS;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < TILE * H / 32; ++k) {
        const int i = lane + 32 * k, q = i / H, e = 2 * (i % H), g = t0 + q;
        cp_async8(buf + (q / CHUNK) * CS + (q % CHUNK) * D + e,
                  g < G ? inj + base + (long long)g * sg + e : inj, g < G);
    }
    cp_async_commit();
}

// The Kogge-Stone scan over the lanes: S_l += S_{l-2^k} T_k for the first
// `steps` steps, the taps at taps[k TS].
template <int D>
__device__ __forceinline__ void lane_scan(double (&S)[D], const double* taps,
                                          int steps)
{
    constexpr int TS = Shape<D>::TS;
    const int lane = threadIdx.x & 31;
    for (int k = 0; k < steps; ++k) {
        const int off = 1 << k;
        double P[D];
#pragma unroll
        for (int e = 0; e < D; ++e) {
            const double p = __shfl_up_sync(FULL, S[e], off);
            P[e] = lane >= off ? p : 0.0;
        }
        add_product<D>(S, P, taps + k * TS);
    }
}

// ceil(log2(n)): the scan steps that reach n chunks.
__device__ __forceinline__ int steps_for(int n)
{
    return n > 1 ? 32 - __clz(n - 1) : 0;
}

// v = lane ? shfl_up(x, 1) : first[0 .. D).
template <int D>
__device__ __forceinline__ void shift_up(double (&v)[D], const double (&x)[D],
                                         const double* first)
{
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < D; ++e) {
        const double p = __shfl_up_sync(FULL, x[e], 1);
        v[e] = lane ? p : first[e];
    }
}

// dst[0 .. D) = lane 31's x, after the warp's reads of dst.
template <int D>
__device__ __forceinline__ void keep_last(double* dst, const double (&x)[D])
{
    __syncwarp();
    if ((threadIdx.x & 31) == 31) {
#pragma unroll
        for (int e = 0; e < D; ++e) dst[e] = x[e];
    }
    __syncwarp();
}

template <int D>
__device__ __forceinline__ void store_vec(float* p, const double (&v)[D])
{
#pragma unroll
    for (int e = 0; e < D; e += 2)
        reinterpret_cast<float2*>(p)[e / 2] = make_float2((float)v[e], (float)v[e + 1]);
}

// Shared memory: the taps (float64), the warps' buffers, then the taps'
// float32 staging (apart, so that the first tiles land meanwhile).
template <int D>
size_t ends_smem()
{
    return (size_t)ESLOTS * Shape<D>::TS * (sizeof(double) + sizeof(float))
        + WARPS * Shape<D>::WF * sizeof(float);
}

// (1) The zero-entry ends and the state at every chunk's end: pre[row][c]
// = the state after group 4 c + 3 of the row from a zero start (c <
// ceil(G / 4)), end[row] = the state after group G - 1.
template <int D>
__global__ void __launch_bounds__(THREADS, 12 / WARPS)
group_ends_gemm_kernel(const float* __restrict__ inj,
                       const float* __restrict__ toe, long long ldt,
                       float* __restrict__ end, float* __restrict__ pre,
                       int rows, int K, int G, long long so, long long sk,
                       long long sg)
{
    constexpr int TS = Shape<D>::TS, CS = Shape<D>::CS, WS = Shape<D>::WS;
    extern __shared__ __align__(16) double smem[];
    double* const taps = smem;
    float* const bufs = reinterpret_cast<float*>(smem + ESLOTS * TS);
    float* const stage = bufs + WARPS * Shape<D>::WF;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS + warp;
    float* const buf = bufs + warp * Shape<D>::WF;
    double* const seed = reinterpret_cast<double*>(buf + WS);   // the state before the tile
    const long long base = (long long)(row / K) * so + (long long)(row % K) * sk;
    copy_taps<D>(stage, toe, ldt, ESLOTS, G, [](int j) { return ends_tap(j); });
    cp_async_commit();
    if (row < rows) load_tile<D>(buf, inj, base, sg, 0, G);
    else cp_async_commit();                    // an empty group: the count
    widen_taps(taps, stage, ESLOTS * TS);
    if (row >= rows) return;
    const int chunks = (G + CHUNK - 1) / CHUNK;     // pre's chunks a row
    for (int t0 = 0; t0 < G; t0 += TILE) {
        const int nt = min(TILE, G - t0), nch = (nt + CHUNK - 1) / CHUNK;
        if (t0) load_tile<D>(buf, inj, base, sg, t0, G);
        cp_async_wait_all();
        __syncwarp();
        const float* c = buf + lane * CS;
        // The chunk's end, inj_3 + inj_2 T_1 + inj_1 T_2 + inj_0 T_3, the
        // earlier tiles' state entering at chunk 0 (T_4).
        double S[D];
        read_vec<D>(S, c + (CHUNK - 1) * D);
#pragma unroll
        for (int i = 0; i < CHUNK - 1; ++i)
            add_group<D>(S, c + i * D, taps + (CHUNK - 2 - i) * TS);
        if (t0 && lane == 0) {
            double sd[D];
#pragma unroll
            for (int e = 0; e < D; ++e) sd[e] = seed[e];
            add_product<D>(S, sd, taps + (CHUNK - 1) * TS);
        }
        lane_scan<D>(S, taps + (CHUNK - 1) * TS,
                     t0 + TILE < G ? STEPS : steps_for(nch));
        if (lane < nch)
            store_vec<D>(pre + ((long long)row * chunks + t0 / CHUNK + lane) * D, S);
        if (t0 + TILE < G) {                 // the tile's end enters the next
            keep_last<D>(seed, S);
            continue;
        }
        // The row's end: at the end of chunk (nt - 1) / 4, or inside it.
        const int at = (nt - 1) / CHUNK, i = (nt - 1) % CHUNK;
        if (i < CHUNK - 1) {
            double Rv[D];
            if (t0 == 0) {
                if (lane < D) seed[lane] = 0.0;
                __syncwarp();
            }
            shift_up<D>(Rv, S, seed);
            read_vec<D>(S, c + i * D);
            for (int l = 1; l <= i; ++l)
                add_group<D>(S, c + (i - l) * D, taps + (l - 1) * TS);
            add_product<D>(S, Rv, taps + i * TS);
        }
        if (lane == at) store_vec<D>(end + (long long)row * D, S);
    }
}

// Shared memory: T_1 and for CARRY the carry's taps (float64), the warps'
// buffers, the block's seeds (float64), the taps' float32 staging, and for
// CARRY the lanes' own taps T_{4 (l+1)} (float32) and the ends the block's
// carry reads (K - 1 + WARPS rows at most).
template <int D, bool CARRY>
size_t solve_smem(int n, int K)
{
    const int slots = CARRY ? n + STEPS : 1;
    return (size_t)slots * Shape<D>::TS * (sizeof(double) + sizeof(float))
        + WARPS * (Shape<D>::WF * sizeof(float) + D * sizeof(double))
        + (CARRY ? (32 * Shape<D>::TS + (K - 1 + WARPS) * D) * sizeof(float) : 0);
}

// One row's sigma_k (every lane the same value): lane l sums its chunk of
// n blocks, sum_i v_{top-i} C_i (v_0 = sigma0, v_m = e_{m-1} = es[m - 1];
// C_0 = I), and the scan over the lanes with C_{n 2^k} carries the sums to
// lane 31.
template <int D>
__device__ __forceinline__ void carry_tree(double (&X)[D], const double* ctaps,
                                           int n, const float* es,
                                           const float* __restrict__ sigma0,
                                           int o, int k)
{
    constexpr int TS = Shape<D>::TS;
    const int lane = threadIdx.x & 31;
    const int top = k - n * (31 - lane);   // the lane's last block m
#pragma unroll
    for (int e = 0; e < D; ++e) X[e] = 0.0;
    for (int i = 0; i < n && top - i >= 0; ++i) {
        const int m = top - i;
        double v[D];
        read_vec<D>(v, m ? es + (m - 1) * D : sigma0 + (long long)o * D,
                    m || sigma0 != nullptr);
        if (i == 0) {                      // C_0 = I
#pragma unroll
            for (int e = 0; e < D; ++e) X[e] += v[e];
        } else {
            add_product<D>(X, v, ctaps + (i - 1) * TS);
        }
    }
    lane_scan<D>(X, ctaps + (n - 1) * TS, steps_for((k + n) / n));
#pragma unroll
    for (int e = 0; e < D; ++e) X[e] = __shfl_sync(FULL, X[e], 31);
}

// (2) The states entering each group, seeded with each block's entering
// state: out[row][0] = sigma_k, out[row][g + 1] = s_g.  CARRY: sigma_k as
// above (sigma[row] too); else zero.
template <int D, bool CARRY>
__global__ void __launch_bounds__(THREADS, 12 / WARPS)
group_solve_gemm_kernel(const float* __restrict__ inj,
                        const float* __restrict__ toe, long long ldt,
                        const float* __restrict__ pre,
                        const float* __restrict__ end,
                        const float* __restrict__ cw, long long ldc, int n,
                        const float* __restrict__ sigma0,
                        float* __restrict__ sigma, float* __restrict__ out,
                        int rows, int K, int G, long long so, long long sk,
                        long long sg)
{
    constexpr int TS = Shape<D>::TS, CS = Shape<D>::CS, WS = Shape<D>::WS;
    constexpr int H = Shape<D>::H;
    extern __shared__ __align__(16) double smem[];
    const int slots = CARRY ? n + STEPS : 1;
    double* const taps = smem;                 // T_1
    double* const ctaps = smem + TS;           // CARRY: the carry's
    float* const bufs = reinterpret_cast<float*>(smem + slots * TS);
    double* const seeds = reinterpret_cast<double*>(bufs + WARPS * Shape<D>::WF);
    float* const stage = reinterpret_cast<float*>(seeds + WARPS * D);
    float* const ltaps = stage + slots * TS;   // CARRY: T_{4 (l+1)} at l TS
    float* const es = ltaps + 32 * TS;         // CARRY: ends from the first row's signal on
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS + warp;
    const int first = blockIdx.x * WARPS;      // the block's first row
    const int e0 = first - first % K;          // its signal's first row
    float* const buf = bufs + warp * Shape<D>::WF;
    double* const seed = seeds + warp * D;     // the seed's share before the tile
    double* const prev = reinterpret_cast<double*>(buf + WS);  // the zero-entry state before it
    const long long base = (long long)(row / K) * so + (long long)(row % K) * sk;
    copy_taps<D>(stage, toe, ldt, 1, G, [](int) { return 1; });
    if (CARRY) {
        copy_taps<D>(stage + TS, cw, ldc, slots - 1, K,
                     [n](int j) { return carry_tap(j, n); });
        copy_taps<D>(ltaps, toe, ldt, 32, G, [](int j) { return CHUNK * (j + 1); });
        const int ne = min(first + WARPS - 1, rows) - e0;
        for (int i = threadIdx.x; i < ne * H; i += THREADS)
            cp_async8(es + 2 * i, end + (long long)e0 * D + 2 * i, true);
    }
    cp_async_commit();
    if (row < rows) load_tile<D>(buf, inj, base, sg, 0, G);
    else cp_async_commit();                    // an empty group: the count
    // The zero-entry state at the end of each lane's chunk of the first
    // tile (ends kernel), loaded before the carry.
    const int chunks = (G + CHUNK - 1) / CHUNK;
    double P[D];
    read_vec<D>(P, pre + ((long long)row * chunks + lane) * D,
                row < rows && lane < (min(TILE, G) + CHUNK - 1) / CHUNK);
    widen_taps(taps, stage, slots * TS);
    if (CARRY) {
        if (warp == 0) {
            double X[D];
            for (int j = 0; j < WARPS && first + j < rows; ++j) {
                const int r = first + j, o = r / K, k = r % K;
                if (j == 0) {
                    carry_tree<D>(X, ctaps, n, es, sigma0, o, k);
                } else if (k == 0) {           // a signal's first block: sigma0
                    read_vec<D>(X, sigma0 + (long long)o * D, sigma0 != nullptr);
                } else {                       // sigma_k = sigma_{k-1} C_1 + e_{k-1}
                    double Y[D];
                    read_vec<D>(Y, es + (r - 1 - e0) * D);
                    add_product<D>(Y, X, ctaps);
#pragma unroll
                    for (int e = 0; e < D; ++e) X[e] = Y[e];
                }
                if (lane == 0) {
#pragma unroll
                    for (int e = 0; e < D; ++e) seeds[j * D + e] = X[e];
                    store_vec<D>(out + (long long)r * G * D, X);
                    if (sigma != nullptr) store_vec<D>(sigma + (long long)r * D, X);
                }
            }
        }
        __syncthreads();
    }
    if (row >= rows) return;
    if (!CARRY && lane == 0) {
#pragma unroll
        for (int e = 0; e < D; ++e) out[(long long)row * G * D + e] = 0.f;
    }
    if (lane < D) prev[lane] = 0.0;
    __syncwarp();

    for (int t0 = 0; t0 < G; t0 += TILE) {
        const int nt = min(TILE, G - t0), nch = (nt + CHUNK - 1) / CHUNK;
        if (t0) {
            load_tile<D>(buf, inj, base, sg, t0, G);
            read_vec<D>(P, pre + ((long long)row * chunks + t0 / CHUNK + lane) * D,
                        lane < nch);
        }
        // The state entering the lane's chunk: the zero-entry state before
        // it (the tile's at lane 0), plus the seed's share: the seed times
        // T_{4 l} (each lane its own tap), the seed itself at lane 0.
        double X[D], Y[D];
        shift_up<D>(X, P, prev);
        keep_last<D>(prev, P);
        if (CARRY) {
#pragma unroll
            for (int e = 0; e < D; ++e) {
                P[e] = seed[e];
                Y[e] = 0.0;
            }
            add_product_f32<D>(Y, P, ltaps + lane * TS);    // T_{4 (l+1)}
            shift_up<D>(P, Y, seed);
#pragma unroll
            for (int e = 0; e < D; ++e) X[e] += P[e];
            keep_last<D>(seed, Y);                          // the next tile's
        }
        cp_async_wait_all();
        __syncwarp();
        // Each group: s = s T_1 + inj, stored over the injection it read.
        float* c = buf + lane * CS;
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {
            if (i >= nt) break;
            read_vec<D>(Y, c + i * D);
            add_product<D>(Y, X, taps);
#pragma unroll
            for (int e = 0; e < D; ++e) X[e] = Y[e];
            store_vec<D>(c + i * D, Y);
        }
        __syncwarp();
        // out[t0 + q + 1] = s_{t0 + q}: coalesced 8-byte stores.
        float* o = out + (long long)row * G * D;
        for (int i = lane; i < nt * H; i += 32) {
            const int q = i / H, e = 2 * (i % H), g = t0 + q + 1;
            if (g < G)
                reinterpret_cast<float2*>(o + (long long)g * D + e)[0] =
                    reinterpret_cast<const float2*>(
                        buf + (q / CHUNK) * CS + (q % CHUNK) * D + e)[0];
        }
        __syncwarp();                 // the buffer is read: the next tile may land
    }
}

// (3) s_true = s_in + sigma T_g (the split callers' entry states, after a
// carry of their own): a thread a column g d + e of the rows of its block,
// its d taps in registers, float32; bound by bytes.
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

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem)
{
    if (smem <= 48 * 1024) return 0;
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if ((long long)smem > most) return (int)cudaErrorInvalidValue;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_ends(const float* inj, const float* toe, long long ldt, float* end,
                float* pre, int rows, int K, int G, long long so, long long sk,
                long long sg, cudaStream_t stream)
{
    const size_t smem = ends_smem<D>();
    const int err = allow_smem(group_ends_gemm_kernel<D>, smem);
    if (err) return err;
    group_ends_gemm_kernel<D><<<(rows + WARPS - 1) / WARPS, THREADS, smem, stream>>>(
        inj, toe, ldt, end, pre, rows, K, G, so, sk, sg);
    return (int)cudaGetLastError();
}

template <int D, bool CARRY>
int launch_solve(const float* inj, const float* toe, long long ldt,
                 const float* pre, const float* end, const float* cw,
                 long long ldc, const float* sigma0, float* sigma, float* out,
                 int rows, int K, int G, long long so, long long sk,
                 long long sg, cudaStream_t stream)
{
    const int n = CARRY ? (K + 31) / 32 : 0;
    const size_t smem = solve_smem<D, CARRY>(n, K);
    const int err = allow_smem(group_solve_gemm_kernel<D, CARRY>, smem);
    if (err) return err;
    group_solve_gemm_kernel<D, CARRY><<<(rows + WARPS - 1) / WARPS, THREADS, smem, stream>>>(
        inj, toe, ldt, pre, end, cw, ldc, n, sigma0, sigma, out, rows, K, G,
        so, sk, sg);
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

template <typename Kernel>
int occupancy_of(Kernel kernel, size_t smem, int* out)
{
    cudaFuncAttributes attr;
    int blocks = 0;
    int err = (int)cudaFuncGetAttributes(&attr, kernel);
    if (!err) err = allow_smem(kernel, smem);
    if (!err)
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
    if (err) return err;
    out[0] = blocks;
    out[1] = attr.numRegs;
    out[2] = (int)attr.localSizeBytes;
    out[3] = (int)smem;
    out[4] = THREADS;
    return 0;
}

template <int D>
int occupancy(int which, int K, int* out)
{
    if (which == 0) return occupancy_of(group_ends_gemm_kernel<D>, ends_smem<D>(), out);
    if (which == 1)
        return occupancy_of(group_solve_gemm_kernel<D, true>,
                            solve_smem<D, true>((K + 31) / 32, K), out);
    return occupancy_of(group_solve_gemm_kernel<D, false>, solve_smem<D, false>(0, K), out);
}

}  // namespace

#define GS_DISPATCH(CALL)                                                 \
    switch (d) {                                                          \
    case 2: return CALL(2);                                               \
    case 4: return CALL(4);                                               \
    case 6: return CALL(6);                                               \
    case 8: return CALL(8);                                               \
    case 10: return CALL(10);                                             \
    case 12: return CALL(12);                                             \
    case 14: return CALL(14);                                             \
    case 16: return CALL(16);                                             \
    default: return (int)cudaErrorInvalidValue;                           \
    }

extern "C" {

// The block rows of a launch: rows = outer x K; inj at inj + (row / K) so
// + (row % K) sk + g sg + e (floats; the pointer and strides even); the
// taps from the first d rows of toe (row stride ldt) and of cw (carry_w,
// row stride ldc), unit column stride, even strides; every other array
// contiguous; d even in 2..16.  Each returns cudaGetLastError() (0 on
// success).

// The zero-entry ends end (rows, d), and pre (rows, ceil(G / 4), d): the
// state at the end of every chunk of 4 groups, for the solve kernel.
int group_ends_launch(const float* inj, const float* toe, float* end,
                      float* pre, int rows, int K, int G, int d, long long so,
                      long long sk, long long sg, long long ldt, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GS_ENDS(D) launch_ends<D>(inj, toe, ldt, end, pre, rows, K, G, so, sk, sg, s)
    GS_DISPATCH(GS_ENDS)
#undef GS_ENDS
}

// The true states entering each group, s_true (rows, G, d), and sigma
// (rows, d), from the same injections, end and pre of group_ends_launch,
// the carry taps and sigma0 (rows / K, d; NULL for zero).
int group_solve_launch(const float* inj, const float* toe, const float* pre,
                       const float* end, const float* cw,
                       const float* sigma0, float* s_true, float* sigma,
                       int rows, int K, int G, int d, long long so,
                       long long sk, long long sg, long long ldt,
                       long long ldc, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GS_SOLVE(D) launch_solve<D, true>(inj, toe, ldt, pre, end, cw, ldc,   \
                                          sigma0, sigma, s_true, rows, K, G,  \
                                          so, sk, sg, s)
    GS_DISPATCH(GS_SOLVE)
#undef GS_SOLVE
}

// Zero-entry group states s_in (rows, G, d), the state entering each
// group (s_in[0] = 0): the solve kernel with a zero seed, from the same
// injections and the pre of group_ends_launch.
int group_states_launch(const float* inj, const float* toe, const float* pre,
                        float* s_in, int rows, int K, int G, int d,
                        long long so, long long sk, long long sg,
                        long long ldt, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GS_STATES(D) launch_solve<D, false>(inj, toe, ldt, pre, nullptr,      \
                                            nullptr, 0, nullptr, nullptr,     \
                                            s_in, rows, K, G, so, sk, sg, s)
    GS_DISPATCH(GS_STATES)
#undef GS_STATES
}

// s_true = s_in + sigma T_g over rows block rows: s_in and s_true (rows,
// G, d), sigma (rows, d), all contiguous; the taps from toe's first d rows.
int group_entry_launch(const float* s_in, const float* sigma, const float* toe,
                       float* s_true, int rows, int G, int d, long long ldt,
                       void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GS_ENTRY(D) launch_entry<D>(s_in, sigma, toe, s_true, rows, G, ldt, s)
    GS_DISPATCH(GS_ENTRY)
#undef GS_ENTRY
}

// out = {blocks a multiprocessor, registers a thread, local (spilled)
// bytes a thread, dynamic shared bytes a block, threads a block} of
// kernel `which` (0 ends, 1 solve, 2 zero-seed solve) at d and K.
int group_states_occupancy(int which, int d, int K, int* out)
{
#define GS_OCC(D) occupancy<D>(which, K, out)
    GS_DISPATCH(GS_OCC)
#undef GS_OCC
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
