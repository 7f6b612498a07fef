// The dynamic EQ's device gain builder for Hopper, float64 SIMT: the six
// bands' design, their powers, and the block tables of one gain vector in
// three launches.
//
// Replaces no TPU kernel.  The JAX package builds these tables with plain
// JAX ops in df32 (dsp_audio_project_tpu/ops/eq_dynamic.py:228
// _dynamic_operators, :304 _lower_triangle, :536 build_dynamic_operators);
// the port did the same with ~220 small float64 torch ops a gain change
// (kept as the plain version, kernels/eq_design.py
// dynamic_operators_plain).  A slider render pays for every one of them.
//
// The tables are views of the powers of one order-d system A (d = 2 nb):
// pu = A^u (u < U: group_in = A^{U-1-v} B, group_out = (C A^u)^T, seq =
// C A^u B), pg = Q^g with Q = A^U (g <= G: pows_g, A_blk, the group
// Toeplitz triangle) and pk = R^k with R = Q^G (k < K: the carry
// triangle).  ~430 matrices of 12 x 12 at the slider's geometry (U = 160,
// G = 128, K = 144).  The plain version raises them by batched doubling,
// ~25 levels in a chain, ~0.78 M float64 multiply-adds; on one SM each
// level is a barrier-separated step.  Here every power is a product of heads,
// P^n = prod over the set bits i of n of P^(2^i), so only the heads form a
// chain:
//
// 1. eq_design_f64_kernel, ONE block: the 0.1 dB mask, each band's
//    closed-form 2x2 realization (the complex- and real-pole branches
//    picked per band, the branch not taken with its divisions guarded; the
//    plain version's operations in its order, none contracted into an FMA:
//    __dadd_rn / __dmul_rn / __ddiv_rn), the series composition into
//    (A, B, C, D), then the heads by squaring: A^(2^i) for 2^i <= U, Q =
//    A^U from them, Q^(2^i) for 2^i <= G, R = Q^G, R^(2^i) for 2^i < K.
//    ~22 products of 12 x 12 in a chain, one element a thread and one
//    barrier a product: bound by that chain's latency, not by bytes or the
//    card's rate.  Writes the heads, B, C and D to a float64 scratch.
// 2. eq_powers_f64_kernel, a block a power (U + G + 1 + K blocks): the
//    product of the heads over the bits of its index (<= 7 products below
//    256), then its share of the small tables: for A^u, group_in's row
//    U-1-u, group_out's column u and seq[u] = C A^u B (float64); for Q^g
//    and R^k, the power rounded to float32 once and written transposed,
//    tT[j][a][b] = f32(P_j[b][a]), and pows_g[g] / A_blk as they are.
// 3. eq_expand_f64_kernel, a block a row: the two block triangles toe
//    (G d, G d) and carry_w (K d, K d), block (v, r) = P_{r-v}^T for v <= r
//    and 0 above, 16-byte loads from tT and stores where d % 4 == 0, and
//    fir_t (U, U), T[v][u] = seq[u-1-v] for u > v, D on the diagonal.  At
//    the slider's geometry it writes ~21.5 MB (toe 9.44, carry_w 11.94):
//    6.4 us at 3.35 TB/s, bound by bytes; tT (157 KB) is read from L2.
//
// The products sum in float64 in another order than the plain version's
// (its heads are out[m-1] @ A, its powers out[m + j] = A^m @ out[j]), so
// a float32 table may differ from it by one rounding; most are equal bit
// for bit.  No atomics, nothing allocated, nothing read back to the host:
// the launches are captured in a CUDA graph as they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DESIGN_THREADS = 256;   // >= d * d for d <= 16
constexpr int POWER_THREADS = 256;
constexpr int EXPAND_THREADS = 128;
constexpr int EXPAND_BLOCKS_PER_SM = 16;
constexpr int MAX_BANDS = 8;
constexpr int BAND_VALUES = 9;        // A (4), B (2), C (2), D

struct Geometry {
    int nb, U, G, K;                  // K = 0: no dense carry
    double two_q, threshold;
};

// Heads a table needs: P^(2^i) for i < heads(n), n the largest exponent
// raised from them (the bits of every exponent <= n).
__host__ __device__ inline int heads(int n)
{
    int h = 0;
    while (n >> h) ++h;
    return h;
}

// out = X @ Y, d x d dense matrices in shared memory, one element a
// thread; out aliases neither.  Ends with a barrier.
template <int D>
__device__ __forceinline__ void mul(double* out, const double* X,
                                    const double* Y)
{
    for (int idx = threadIdx.x; idx < D * D; idx += blockDim.x) {
        const int i = idx / D, c = idx % D;
        double acc = 0.0;
#pragma unroll
        for (int k = 0; k < D; ++k) acc = fma(X[i * D + k], Y[k * D + c], acc);
        out[idx] = acc;
    }
    __syncthreads();
}

// out = P^n from the heads H[i] = P^(2^i): the heads of n's set bits
// multiplied from the highest down (n = 0: the identity).  w: one d x d
// scratch matrix; out, w and H in shared memory.  Uniform in the block.
template <int D>
__device__ void power(double* out, const double* H, int n, double* w)
{
    constexpr int DD = D * D;
    int hi = 31;
    while (hi >= 0 && !(n >> hi & 1)) --hi;
    int rest = 0;                               // products after the first
    for (int i = hi - 1; i >= 0; --i) rest += n >> i & 1;
    // Alternate between out and w so that the last product lands in out.
    double* dst = rest % 2 ? out : w;
    const double* X = H + (hi < 0 ? 0 : hi) * DD;
    if (hi < 0 || rest == 0) {
        for (int idx = threadIdx.x; idx < DD; idx += blockDim.x)
            out[idx] = hi < 0 ? (idx / D == idx % D ? 1.0 : 0.0) : X[idx];
        __syncthreads();
        return;
    }
    for (int i = hi - 1; i >= 0; --i) {
        if (!(n >> i & 1)) continue;
        mul<D>(dst, X, H + i * DD);
        X = dst;
        dst = dst == out ? w : out;
    }
}

// One band's realization (the plain version's _band_realization, its
// operations in order, each rounded once).  Writes A (4), B (2), C (2), D.
__device__ void band_design(double g, double s, double c, double two_q,
                            double* out)
{
    const double amp = pow(10.0, __ddiv_rn(g, 40.0));
    const double alpha = __ddiv_rn(s, two_q);
    const double al_over = __ddiv_rn(alpha, amp);
    const double al_times = __dmul_rn(alpha, amp);
    const double a0 = __dadd_rn(1.0, al_over);
    const double a1 = __ddiv_rn(__dmul_rn(-2.0, c), a0);
    const double a2 = __ddiv_rn(__dsub_rn(1.0, al_over), a0);
    const double b0 = __ddiv_rn(__dadd_rn(1.0, al_times), a0);
    const double c1 = __dmul_rn(
        a1, __ddiv_rn(__dmul_rn(alpha, __dsub_rn(__ddiv_rn(1.0, amp), amp)),
                      a0));
    const double c0 = __dsub_rn(__ddiv_rn(__dsub_rn(1.0, al_times), a0),
                                __dmul_rn(b0, a2));
    const double m = __dmul_rn(-0.5, a1);
    const double disc4 = __ddiv_rn(
        __dmul_rn(__dmul_rn(s, s),
                  __dsub_rn(__ddiv_rn(1.0, __dmul_rn(amp, amp)), 4.0)),
        __dmul_rn(__dmul_rn(4.0, a0), a0));
    const bool cplx = disc4 < 0.0;
    const double root = __dsqrt_rn(fabs(disc4));
    const double r_safe = cplx ? fmax(root, 1e-300) : 1.0;
    const double g2_c = __ddiv_rn(-__dadd_rn(c0, __dmul_rn(c1, m)), r_safe);
    const double l1 = __dadd_rn(m, root);
    const double l2 = __dsub_rn(m, root);
    const double denom = cplx ? 1.0 : __dadd_rn(__dsub_rn(1.0, l2), l1);
    const double g1_r = __ddiv_rn(__dadd_rn(c0, __dmul_rn(c1, l1)), denom);
    out[0] = cplx ? m : l1;
    out[1] = cplx ? root : 1.0;
    out[2] = cplx ? -root : 0.0;
    out[3] = cplx ? m : l2;
    out[4] = 1.0;
    out[5] = cplx ? 0.0 : 1.0;
    out[6] = cplx ? c1 : g1_r;
    out[7] = cplx ? g2_c : __dsub_rn(c1, g1_r);
    out[8] = b0;
}

// The product of the bands' D over k in (lo, hi), in band order (1 if
// empty), as torch's prod over a row of where(mask, D, 1).
__device__ double d_product(const double* bands, int nb, int lo, int hi)
{
    double p = 1.0;
    for (int k = 0; k < nb; ++k)
        p = __dmul_rn(p, (k > lo && k < hi) ? bands[k * BAND_VALUES + 8] : 1.0);
    return p;
}

// The float64 scratch: seq (U), D, B (d), C (d), then the heads of A, Q
// and R (d x d each).
struct Scratch {
    double* seq;
    double* Dv;
    double* B;
    double* C;
    double* hA;
    double* hQ;
    double* hR;
    int nA, nQ, nR;
    __device__ Scratch(double* s, const Geometry& g, int D)
    {
        nA = heads(g.U);
        nQ = heads(g.G);
        nR = g.K ? heads(g.K - 1) : 0;
        seq = s;
        Dv = s + g.U;
        B = Dv + 1;
        C = B + D;
        hA = C + D;
        hQ = hA + nA * D * D;
        hR = hQ + nQ * D * D;
    }
};

template <int D>
__global__ void __launch_bounds__(DESIGN_THREADS)
eq_design_f64_kernel(const float* __restrict__ gains,
                     const double* __restrict__ sin_w0,
                     const double* __restrict__ cos_w0, Geometry geo,
                     double* __restrict__ scratch)
{
    constexpr int DD = D * D;
    extern __shared__ __align__(16) double smem[];
    const Scratch sc(scratch, geo, D);
    const int nb = geo.nb, nh = sc.nA + sc.nQ + sc.nR;
    double* bands = smem;                        // MAX_BANDS * BAND_VALUES
    double* vals = bands + MAX_BANDS * BAND_VALUES;   // D, B, C as in sc
    double* hA = vals + 1 + 2 * D;               // the heads, as in sc
    double* hQ = hA + sc.nA * DD;
    double* hR = hQ + sc.nQ * DD;
    double* w = hR + sc.nR * DD;                 // one matrix of scratch

    // The mask and each band's realization.
    if (threadIdx.x < nb) {
        const int i = threadIdx.x;
        const double g = (double)gains[i];
        band_design(fabs(g) > geo.threshold ? g : 0.0, sin_w0[i], cos_w0[i],
                    geo.two_q, bands + i * BAND_VALUES);
    }
    __syncthreads();

    // The series composition (the plain version's _compose_cascade): A
    // into hA[0], then D, B, C.
    for (int idx = threadIdx.x; idx < DD + 2 * D + 1; idx += blockDim.x) {
        if (idx < DD) {
            const int row = idx / D, col = idx % D;
            const int i = row / 2, p = row % 2, j = col / 2, q = col % 2;
            double v = 0.0;
            if (j < i)
                v = __dmul_rn(__dmul_rn(d_product(bands, nb, j, i),
                                        bands[i * BAND_VALUES + 4 + p]),
                              bands[j * BAND_VALUES + 6 + q]);
            else if (j == i)
                v = bands[i * BAND_VALUES + 2 * p + q];
            hA[idx] = v;
        } else if (idx < DD + D) {
            const int r = idx - DD;
            vals[1 + r] = __dmul_rn(bands[(r / 2) * BAND_VALUES + 4 + r % 2],
                                    d_product(bands, nb, -1, r / 2));
        } else if (idx < DD + 2 * D) {
            const int r = idx - DD - D;
            vals[1 + D + r] = __dmul_rn(
                bands[(r / 2) * BAND_VALUES + 6 + r % 2],
                d_product(bands, nb, r / 2, nb));
        } else {
            vals[0] = d_product(bands, nb, -1, nb);
        }
    }
    __syncthreads();

    // The heads: A^(2^i), Q = A^U, Q^(2^i), R = Q^G, R^(2^i).
    for (int i = 1; i < sc.nA; ++i) mul<D>(hA + i * DD, hA + (i - 1) * DD,
                                           hA + (i - 1) * DD);
    power<D>(hQ, hA, geo.U, w);
    for (int i = 1; i < sc.nQ; ++i) mul<D>(hQ + i * DD, hQ + (i - 1) * DD,
                                           hQ + (i - 1) * DD);
    if (sc.nR) {
        power<D>(hR, hQ, geo.G, w);
        for (int i = 1; i < sc.nR; ++i) mul<D>(hR + i * DD, hR + (i - 1) * DD,
                                               hR + (i - 1) * DD);
    }
    // D, B, C and the heads, contiguous in shared memory as in sc.
    for (int idx = threadIdx.x; idx < 1 + 2 * D + nh * DD; idx += blockDim.x)
        sc.Dv[idx] = vals[idx];
}

// A block a power: blocks [0, U) raise A^u, [U, U + G + 1) Q^g, then
// [.., + K) R^k.
template <int D>
__global__ void __launch_bounds__(POWER_THREADS)
eq_powers_f64_kernel(double* __restrict__ scratch, Geometry geo,
                     float* __restrict__ group_in,
                     float* __restrict__ group_out, float* __restrict__ tT,
                     float* __restrict__ pows_g, float* __restrict__ a_blk)
{
    constexpr int DD = D * D;
    extern __shared__ __align__(16) double smem[];
    const Scratch sc(scratch, geo, D);
    const int U = geo.U, G = geo.G;
    int n = blockIdx.x, table = 0;
    if (n >= U) {
        n -= U;
        table = 1;
        if (n > G) {
            n -= G + 1;
            table = 2;
        }
    }
    const double* src = table == 0 ? sc.hA : table == 1 ? sc.hQ : sc.hR;
    const int nh = heads(n);
    double* X = smem;                            // the power
    double* w = X + DD;
    double* bc = w + DD;                         // B, C, C A^u
    double* H = bc + 3 * D;                      // the heads n needs
    for (int idx = threadIdx.x; idx < nh * DD; idx += blockDim.x)
        H[idx] = src[idx];
    for (int idx = threadIdx.x; idx < 2 * D; idx += blockDim.x)
        bc[idx] = sc.B[idx];
    __syncthreads();
    power<D>(X, H, n, w);

    if (table == 0) {
        // group_in[U-1-u] = A^u B, group_out[:, u] = C A^u, seq[u].
        const int u = n;
        for (int idx = threadIdx.x; idx < 2 * D; idx += blockDim.x) {
            double acc = 0.0;
            if (idx < D) {
#pragma unroll
                for (int k = 0; k < D; ++k)
                    acc = fma(X[idx * D + k], bc[k], acc);
                group_in[(size_t)(U - 1 - u) * D + idx] = (float)acc;
            } else {
                const int b = idx - D;
#pragma unroll
                for (int a = 0; a < D; ++a)
                    acc = fma(bc[D + a], X[a * D + b], acc);
                group_out[(size_t)b * U + u] = (float)acc;
                bc[2 * D + b] = acc;
            }
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            double s = 0.0;
#pragma unroll
            for (int b = 0; b < D; ++b) s = fma(bc[2 * D + b], bc[b], s);
            sc.seq[u] = s;
        }
        return;
    }
    float* dst = tT + (size_t)(table == 1 ? n : G + 1 + n) * DD;
    for (int idx = threadIdx.x; idx < DD; idx += blockDim.x) {
        const float v = (float)X[idx];
        dst[(idx % D) * D + idx / D] = v;
        if (table == 1) {
            if (n < G) pows_g[(size_t)n * DD + idx] = v;
            else a_blk[idx] = v;
        }
    }
}

// Row `row` of a block triangle (n d, n d) whose blocks come from
// tT[base..base+n): block (v, r) = P_{r-v}^T for v <= r, else 0.  W
// consecutive columns a thread step (W = 4: one 16-byte load and store,
// d % 4 == 0).
template <int W>
__device__ __forceinline__ void triangle_row(const float* __restrict__ tT,
                                             int base, int n, int d, int row,
                                             float* __restrict__ out)
{
    const int width = n * d;
    const int v = row / d, a = row - v * d;
    float* dst = out + (size_t)row * width;
    for (int col = threadIdx.x * W; col < width; col += blockDim.x * W) {
        const int r = col / d, b = col - r * d;
        const int lag = r - v;
        const float* src =
            tT + ((size_t)(base + (lag < 0 ? 0 : lag)) * d + a) * d + b;
        if (W == 4) {
            float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
            if (lag >= 0) val = __ldg(reinterpret_cast<const float4*>(src));
            *reinterpret_cast<float4*>(dst + col) = val;
        } else {
            dst[col] = lag >= 0 ? __ldg(src) : 0.f;
        }
    }
}

// A block a row: the rows of toe, then of carry_w, then of fir_t.
template <int W>
__global__ void __launch_bounds__(EXPAND_THREADS)
eq_expand_f64_kernel(const float* __restrict__ tT,
                     const double* __restrict__ seq, int d, int U, int G,
                     int K, float* __restrict__ toe, float* __restrict__ carry,
                     float* __restrict__ fir_t)
{
    const int rows_toe = G * d, first_fir = rows_toe + K * d;
    const int rows = first_fir + U;
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
        if (row < rows_toe) {
            triangle_row<W>(tT, 0, G, d, row, toe);
        } else if (row < first_fir) {
            triangle_row<W>(tT, G + 1, K, d, row - rows_toe, carry);
        } else {
            // fir[u][v] + D eye, transposed: the plain version's sums.
            const int v = row - first_fir;
            const double dv = seq[U];
            for (int u = threadIdx.x; u < U; u += blockDim.x) {
                const double val = u > v
                    ? __dadd_rn(seq[u - 1 - v], __dmul_rn(dv, 0.0))
                    : __dadd_rn(0.0, __dmul_rn(dv, u == v ? 1.0 : 0.0));
                fir_t[(size_t)v * U + u] = (float)val;
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

template <int D>
int launch_tables(const float* gains, const double* sin_w0,
                  const double* cos_w0, const Geometry& geo, float* group_in,
                  float* group_out, float* tT, float* pows_g, float* a_blk,
                  double* scratch, cudaStream_t stream)
{
    constexpr int DD = D * D;
    const int nA = heads(geo.U), nQ = heads(geo.G);
    const int nR = geo.K ? heads(geo.K - 1) : 0;
    const size_t design_smem =
        sizeof(double) * (MAX_BANDS * BAND_VALUES + 1 + 2 * D
                          + (nA + nQ + nR + 1) * DD);
    cudaError_t err = cudaFuncSetAttribute(
        eq_design_f64_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)design_smem);
    if (err != cudaSuccess) return (int)err;
    eq_design_f64_kernel<D><<<1, DESIGN_THREADS, design_smem, stream>>>(
        gains, sin_w0, cos_w0, geo, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int most = nA > nQ ? (nA > nR ? nA : nR) : (nQ > nR ? nQ : nR);
    const size_t power_smem = sizeof(double) * ((most + 2) * DD + 3 * D);
    err = cudaFuncSetAttribute(
        eq_powers_f64_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)power_smem);
    if (err != cudaSuccess) return (int)err;
    eq_powers_f64_kernel<D>
        <<<geo.U + geo.G + 1 + geo.K, POWER_THREADS, power_smem, stream>>>(
            scratch, geo, group_in, group_out, tT, pows_g, a_blk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The three kernels on `stream`; returns the first nonzero
// cudaGetLastError() (0 on success).  The caller (kernels/eq_design.py)
// checks the geometry and sizes every buffer: nb in 1..8, K = 0 without a
// dense carry, `scratch` of U + 1 + 2 d + (heads(U) + heads(G) +
// heads(K - 1)) d d doubles, `tT` of (G + 1 + K) d d floats.
int eq_design_launch(const float* gains, const double* sin_w0,
                     const double* cos_w0, int nb, int U, int G, int K,
                     double two_q, double threshold, float* group_in,
                     float* group_out, float* fir_t, float* toe,
                     float* pows_g, float* a_blk, float* carry, float* tT,
                     double* scratch, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Geometry geo{nb, U, G, K, two_q, threshold};
    int err = 0;
    switch (nb) {
#define TABLES_CASE(NB)                                                       \
    case NB:                                                                  \
        err = launch_tables<2 * NB>(gains, sin_w0, cos_w0, geo, group_in,     \
                                    group_out, tT, pows_g, a_blk, scratch, s); \
        break;
        TABLES_CASE(1) TABLES_CASE(2) TABLES_CASE(3) TABLES_CASE(4)
        TABLES_CASE(5) TABLES_CASE(6) TABLES_CASE(7) TABLES_CASE(8)
#undef TABLES_CASE
    default:
        return (int)cudaErrorInvalidValue;
    }
    if (err) return err;
    const int d = 2 * nb;
    const int rows = G * d + K * d + U;
    const int most = sm_count() * EXPAND_BLOCKS_PER_SM;
    const int grid = rows < most ? rows : most;
    if (d % 4 == 0)
        eq_expand_f64_kernel<4><<<grid, EXPAND_THREADS, 0, s>>>(
            tT, scratch, d, U, G, K, toe, carry, fir_t);
    else
        eq_expand_f64_kernel<1><<<grid, EXPAND_THREADS, 0, s>>>(
            tT, scratch, d, U, G, K, toe, carry, fir_t);
    return (int)cudaGetLastError();
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
