// The dynamic EQ's device gain builder for Hopper, float64: the six bands'
// design, their powers, and the block tables of one gain vector in two
// launches.
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
// C A^u B, fir_t), pg = Q^g = A^(U g) (g <= G: pows_g, A_blk, the group
// Toeplitz triangle toe) and pk = R^k = A^(U G k) (k < K: the carry
// triangle carry_w).  433 matrices of 12 x 12 at the slider's geometry (U
// = 160, G = 128, K = 144).  Every one is A^e for its exponent e, the
// product of the heads A^(2^i) over e's set bits, so only the heads form a
// chain: 22 squarings (2^21 <= 160 * 128 * 143), bound by their latency,
// not by bytes or the card's float64 rate.  The tables' 21.5 MB (toe 9.44,
// carry_w 11.94) are bound by bytes: 6.4 us at 3.35 TB/s.  Half of that is
// the zeros left of the triangles' block diagonal, which need no power.
//
// 1. eq_design_f64_kernel, two kinds of block:
//    * a power block owns a pair of powers of one table, indices b and
//      n-1-b (the carry's first, then Q's, then A's).  Warp 0 designs the
//      bands, four lanes a band taking its independent divisions side by
//      side (the plain version's operations in its order, none contracted
//      into an FMA: __dadd_rn / __dmul_rn / __ddiv_rn / __dsqrt_rn, pow),
//      and the products of their D over each run; the block composes them
//      in series into (A, B, C, D).  Then the chain: pass p squares head p
//      into head p + 1 and, side by side, multiplies each of its powers'
//      running products by head p where the power's exponent has bit p
//      set, so a power is done one pass after its highest head.  A product
//      runs on the FP64 tensor cores (mma m8n8k4), each warp one 8x8
//      output tile of one product for the whole chain (the d x d matrices
//      zero-padded to 16 x 16, or 8 x 8 for d <= 8, in shared memory with
//      a row stride that keeps the fragments' loads free of bank
//      conflicts), its k-steps of 4 in order; one barrier a pass.  Then
//      its powers' share of the tables, each power rounded to float32
//      once: for A^u group_in's row U-1-u, group_out's column u and fir_t's
//      diagonal u + 1 (seq[u] = C A^u B in float64, D on the main
//      diagonal); for Q^g and R^k the power transposed into tT, and pows_g
//      (or A_blk).
//    * a zero block writes the zeros left of the block diagonal of toe and
//      carry_w and below fir_t's diagonal while the power blocks run their
//      chains.
// 2. eq_expand_f64_kernel, a programmatic dependent launch of the first: a
//    block a row of toe / carry_w from its diagonal block on, block (v, r)
//    = P_{r-v}^T for r >= v read from tT (157 KB, from L2), 16-byte loads
//    and stores where d % 4 == 0 (else 8-byte).  (Written by the power
//    blocks themselves, a block diagonal at a time, the triangles' 48-byte
//    row pieces reached the card at ~0.9 TB/s, slower than this second
//    launch.)
//
// No block of the first grid waits for another: each power block computes
// every head it needs itself.  The one wait is the expand's
// griddepcontrol.wait for the first grid's end.  The first grid triggers
// no early launch, so the expand's blocks are scheduled only as its blocks
// exit (scheduled at its start, they slowed the call by ~0.9 us): they
// hold no slot a block of the first grid needs, and the first grid ends
// whatever the expand does.  Hence no deadlock, by the launch's own rule
// and with no assumption on occupancy.  No atomics,
// no flags, nothing allocated, nothing read back to the host: both
// launches are captured in a CUDA graph as they are, and two calls on two
// streams share nothing but the read-only inputs.  A refused launch
// returns its error; there is no other body.
//
// The products sum in float64 in another order than the plain version's
// (its powers come by batched doubling, out[m + j] = A^m @ out[j]), so a
// float32 table may differ from it by one rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef DESIGN_STAMP
#define DESIGN_STAMP(phase) ((void)0)
#endif

namespace {

constexpr int JOBS = 3;               // a pass: the squaring, two products
constexpr int ZERO_BLOCKS_PER_SM = 1;
constexpr int EXPAND_THREADS = 128;
constexpr int EXPAND_BLOCKS_PER_SM = 16;
constexpr int MAX_BANDS = 8;
constexpr int BAND_VALUES = 9;        // A (4), B (2), C (2), D
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Shape {
    static constexpr int DD = D * D;
    static constexpr int TD = D <= 8 ? 8 : 16;      // padded side: 8x8 tiles
    static constexpr int LD = TD + 4;               // row stride, doubles
    static constexpr int MAT = TD * LD;             // doubles a matrix
    static constexpr int TILES = (TD / 8) * (TD / 8);    // warps a product
    static constexpr int KC = (D + 3) / 4;          // k-steps of 4
    static constexpr int THREADS =
        JOBS * TILES * 32 < 128 ? 128 : JOBS * TILES * 32;
    static constexpr int W = D % 4 == 0 ? 4 : 2;    // floats a store
    // Shared matrices: the two heads, then each power's two running
    // products, zero outside their d x d corner.
    static constexpr int HEAD = 0, RUN = 2 * MAT, MATS = 6 * MAT;
};

struct Geometry {
    int nb, U, G, K;                  // K = 0: no dense carry
    double two_q, threshold;
    int blocks_r, blocks_q, blocks_a; // power blocks of each table
};

// A pair of powers a block: b and n-1-b of n.
__host__ __device__ inline int pair_blocks(int n) { return (n + 1) / 2; }

__device__ inline int bit_length(unsigned long long e)
{
    return e ? 64 - __clzll((long long)e) : 0;
}

// Each band's realization (the plain version's _band_realization, its
// operations in order, each rounded once), by warp 0: four lanes a band
// (lane 4 i + r), which take the band's independent divisions side by side
// (one __ddiv_rn a lane a level, operands picked by r) and exchange them
// by shuffles; lanes past the bands repeat band 0.  Writes, for each band,
// A (4), B (2), C (2) and D into `bands`.
__device__ void band_design(const float* __restrict__ gains,
                            const double* __restrict__ sin_w0,
                            const double* __restrict__ cos_w0,
                            const Geometry& geo, double* bands)
{
    const int lane = threadIdx.x, r = lane & 3, base = lane & ~3;
    const int i = (lane >> 2) < geo.nb ? lane >> 2 : 0;
    const double gain = (double)gains[i];
    const double g = fabs(gain) > geo.threshold ? gain : 0.0;
    const double s = sin_w0[i], c = cos_w0[i];
    auto from = [&](double v, int role) {
        return __shfl_sync(FULL, v, base + role);
    };
    // g / 40 (r = 0), s / 2q (r = 1).
    const double q1 = __ddiv_rn(r == 1 ? s : g, r == 1 ? geo.two_q : 40.0);
    const double amp = pow(10.0, from(q1, 0));
    if (amp != 0.0) DESIGN_STAMP(1);  // design: inputs read and pow
    const double alpha = from(q1, 1);
    // alpha / amp (r = 0, 3), 1 / amp (r = 1), 1 / amp^2 (r = 2).
    const double q2 = __ddiv_rn(r == 1 || r == 2 ? 1.0 : alpha,
                                r == 2 ? __dmul_rn(amp, amp) : amp);
    const double al_over = from(q2, 0), inv_amp = from(q2, 1);
    const double inv_amp2 = from(q2, 2);
    const double al_times = __dmul_rn(alpha, amp);
    const double a0 = __dadd_rn(1.0, al_over);
    // a1 (r = 0), a2 (r = 1), b0 (r = 2), disc4 (r = 3).
    const double n3 = r == 0 ? __dmul_rn(-2.0, c)
        : r == 1 ? __dsub_rn(1.0, al_over)
        : r == 2 ? __dadd_rn(1.0, al_times)
        : __dmul_rn(__dmul_rn(s, s), __dsub_rn(inv_amp2, 4.0));
    const double q3 =
        __ddiv_rn(n3, r == 3 ? __dmul_rn(__dmul_rn(4.0, a0), a0) : a0);
    const double a1 = from(q3, 0), a2 = from(q3, 1), b0 = from(q3, 2);
    const double disc4 = from(q3, 3);
    // c1's quotient (r = 0, 2, 3) and c0's (r = 1).
    const double q4 = __ddiv_rn(
        r == 1 ? __dsub_rn(1.0, al_times)
               : __dmul_rn(alpha, __dsub_rn(inv_amp, amp)),
        a0);
    const double c1 = __dmul_rn(a1, from(q4, 0));
    const double c0 = __dsub_rn(from(q4, 1), __dmul_rn(b0, a2));
    const double m = __dmul_rn(-0.5, a1);
    const bool cplx = disc4 < 0.0;
    const double root = __dsqrt_rn(fabs(disc4));
    const double r_safe = cplx ? fmax(root, 1e-300) : 1.0;
    const double l1 = __dadd_rn(m, root);
    const double l2 = __dsub_rn(m, root);
    const double denom = cplx ? 1.0 : __dadd_rn(__dsub_rn(1.0, l2), l1);
    // g2_c (r = 0, 2, 3), g1_r (r = 1).
    const double q5 = __ddiv_rn(
        r == 1 ? __dadd_rn(c0, __dmul_rn(c1, l1))
               : -__dadd_rn(c0, __dmul_rn(c1, m)),
        r == 1 ? denom : r_safe);
    const double g2_c = from(q5, 0), g1_r = from(q5, 1);
    if (r == 0 && (lane >> 2) < geo.nb) {
        double* out = bands + i * BAND_VALUES;
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
}

// d0, d1 += a b over one k-step of 4, the FP64 tensor cores' 8x8x4 product:
// lane l holds a = A[l / 4][l % 4], b = B[l % 4][l / 4] and the outputs
// C[l / 4][2 (l % 4) + i].
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b)
{
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};"
        : "+d"(d0), "+d"(d1)
        : "d"(a), "d"(b));
}

// One product or copy by one warp: its 8x8 tile (fragment offsets fx, fy,
// fo in a padded matrix) of O = X @ Y, X, Y, O offsets of the shared array
// `mats` (Y < 0: O = X, a copy), its k-steps of 4 in order on the FP64
// tensor cores.
template <int D>
__device__ __forceinline__ void tile_product(double* mats, int X, int Y,
                                             int O, int fx, int fy, int fo)
{
    using S = Shape<D>;
    double d0, d1;
    if (Y < 0) {
        const double2 v = *reinterpret_cast<const double2*>(mats + X + fo);
        d0 = v.x;
        d1 = v.y;
    } else {
        d0 = d1 = 0.0;
#pragma unroll
        for (int kc = 0; kc < S::KC; ++kc)
            mma_f64(d0, d1, mats[X + fx + 4 * kc],
                    mats[Y + fy + 4 * kc * S::LD]);
    }
    *reinterpret_cast<double2*>(mats + O + fo) = make_double2(d0, d1);
}

// The zeros of rows [b, b + n, ...) of toe, carry_w and fir_t: in row r of
// a (m d, m d) triangle the columns left of its block diagonal, [0, (r / d)
// d), W floats a store; in fir_t's row v the columns [0, v).
template <int W>
__device__ void zero_rows(const Geometry& geo, int d, int b, int n,
                          float* __restrict__ toe, float* __restrict__ carry,
                          float* __restrict__ fir_t)
{
    const int rows_toe = geo.G * d, rows_tri = rows_toe + geo.K * d;
    for (int row = b; row < rows_tri + geo.U; row += n) {
        if (row >= rows_tri) {
            const int v = row - rows_tri;
            for (int u = threadIdx.x; u < v; u += blockDim.x)
                fir_t[(size_t)v * geo.U + u] = 0.f;
            continue;
        }
        const bool in_toe = row < rows_toe;
        const int r = in_toe ? row : row - rows_toe;
        const int width = (in_toe ? geo.G : geo.K) * d;
        float* dst = (in_toe ? toe : carry) + (size_t)r * width;
        const int zeros = r / d * d;
        for (int col = threadIdx.x * W; col < zeros; col += blockDim.x * W) {
            if (W == 4)
                *reinterpret_cast<float4*>(dst + col) =
                    make_float4(0.f, 0.f, 0.f, 0.f);
            else
                *reinterpret_cast<float2*>(dst + col) = make_float2(0.f, 0.f);
        }
    }
}

// Blocks [0, blocks_r) raise R^k, then Q^g, then A^u, a pair of indices a
// block; the rest write the zeros.  Three blocks an SM (at most 56
// registers) keep the slider's 349 blocks one wave: at two, the zero
// blocks waited for the chains to end.
template <int D>
__global__ void __launch_bounds__(Shape<D>::THREADS, 3)
eq_design_f64_kernel(const float* __restrict__ gains,
                     const double* __restrict__ sin_w0,
                     const double* __restrict__ cos_w0, Geometry geo,
                     float* __restrict__ group_in,
                     float* __restrict__ group_out, float* __restrict__ fir_t,
                     float* __restrict__ toe, float* __restrict__ pows_g,
                     float* __restrict__ a_blk, float* __restrict__ carry,
                     float* __restrict__ tT)
{
    using S = Shape<D>;
    constexpr int DD = S::DD;
    DESIGN_STAMP(0);  // design: start
    const int power_blocks = geo.blocks_r + geo.blocks_q + geo.blocks_a;
    if ((int)blockIdx.x >= power_blocks) {
        zero_rows<S::W>(geo, D, blockIdx.x - power_blocks,
                        gridDim.x - power_blocks, toe, carry, fir_t);
        DESIGN_STAMP(37);  // design: zeros written
        return;
    }
    __shared__ __align__(16) double bands[MAX_BANDS * BAND_VALUES];
    __shared__ __align__(16) double vals[1 + 2 * D];       // D, B, C
    __shared__ __align__(16) double mats[S::MATS];
    __shared__ double ca[2][D];                             // C A^u
    __shared__ double gap[MAX_BANDS + 1][MAX_BANDS + 1];

    // This block's table (0: A^u, 1: Q^g, 2: R^k), count and powers.
    int b = blockIdx.x, table = 2, count = geo.K;
    unsigned long long unit = (unsigned long long)geo.U * geo.G;
    if (b >= geo.blocks_r) {
        b -= geo.blocks_r;
        table = 1;
        count = geo.G + 1;
        unit = geo.U;
        if (b >= geo.blocks_q) {
            b -= geo.blocks_q;
            table = 0;
            count = geo.U;
            unit = 1;
        }
    }
    const int other = count - 1 - b;      // the pair's second index
    const int mine = other > b ? 2 : 1;
    const unsigned long long expo[2] = {
        unit * (unsigned long long)b,
        mine == 2 ? unit * (unsigned long long)other : 0ull};
    const int nb = geo.nb;

    // The mask and each band's realization (warp 0), then the products of
    // the bands' D over each run (lo, hi): gap[lo + 1][hi] = D_{lo+1} ...
    // D_{hi-1} in band order, as the plain version's prod over a row of
    // where(mask, D, 1) (a factor 1 is exact).  The other warps clear the
    // matrices meanwhile.
    for (int idx = (int)threadIdx.x - 32; idx >= 0 && idx < S::MATS;
         idx += blockDim.x - 32)
        mats[idx] = 0.0;
    if (threadIdx.x < 32) {
        band_design(gains, sin_w0, cos_w0, geo, bands);
        __syncwarp();
        if ((int)threadIdx.x <= nb) {
            const int lo1 = threadIdx.x;
            double p = 1.0;
            gap[lo1][lo1] = p;
            for (int hi = lo1; hi < nb; ++hi) {
                p = __dmul_rn(p, bands[hi * BAND_VALUES + 8]);
                gap[lo1][hi + 1] = p;
            }
        }
    }
    __syncthreads();
    DESIGN_STAMP(2);  // design: bands

    // The series composition (the plain version's _compose_cascade): A
    // into the first head, then D, B, C.
    for (int idx = threadIdx.x; idx < DD + 2 * D + 1; idx += blockDim.x) {
        if (idx < DD) {
            const int row = idx / D, col = idx % D;
            const int i = row / 2, p = row % 2, j = col / 2, q = col % 2;
            double v = 0.0;
            if (j < i)
                v = __dmul_rn(__dmul_rn(gap[j + 1][i],
                                        bands[i * BAND_VALUES + 4 + p]),
                              bands[j * BAND_VALUES + 6 + q]);
            else if (j == i)
                v = bands[i * BAND_VALUES + 2 * p + q];
            mats[S::HEAD + row * S::LD + col] = v;
        } else if (idx < DD + D) {
            const int r = idx - DD;
            vals[1 + r] = __dmul_rn(bands[(r / 2) * BAND_VALUES + 4 + r % 2],
                                    gap[0][r / 2]);
        } else if (idx < DD + 2 * D) {
            const int r = idx - DD - D;
            vals[1 + D + r] = __dmul_rn(
                bands[(r / 2) * BAND_VALUES + 6 + r % 2], gap[r / 2 + 1][nb]);
        } else {
            vals[0] = gap[0][nb];
        }
    }
    __syncthreads();
    DESIGN_STAMP(3);  // design: composition

    // The chain.  Pass p: head p+1 = (head p)^2, and each running product
    // whose exponent has bit p times head p (its first factor copied).
    // Warp w keeps one slot (0: the squaring, 1 + j: power j) and one 8x8
    // tile of it through every pass.
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int slot = warp / S::TILES, tile = warp % S::TILES;
    const int r0 = 8 * (tile / (S::TD / 8)), c0 = 8 * (tile % (S::TD / 8));
    const int fx = (r0 + lane / 4) * S::LD + lane % 4;
    const int fy = lane % 4 * S::LD + c0 + lane / 4;
    const int fo = (r0 + lane / 4) * S::LD + c0 + 2 * (lane % 4);
    const unsigned long long own = slot == 1 ? expo[0] : expo[1];
    const int run = S::RUN + 2 * (slot - 1) * S::MAT;
    int cur = 0;                          // the head read this pass
    int at[2] = {-1, -1};                 // each running product; -1: none
    const int passes = bit_length(expo[0] > expo[1] ? expo[0] : expo[1]);
    for (int p = 0; p < passes; ++p) {
        const int head = S::HEAD + cur * S::MAT;
        if (slot == 0) {
            if (p + 1 < passes)
                tile_product<D>(mats, head, head,
                                S::HEAD + (cur ^ 1) * S::MAT, fx, fy, fo);
        } else if (slot < JOBS && (own >> p & 1)) {
            const int mine_at = slot == 1 ? at[0] : at[1];
            if (mine_at < 0)
                tile_product<D>(mats, head, -1, run, fx, fy, fo);
            else
                tile_product<D>(mats, run + mine_at * S::MAT, head,
                                run + (mine_at ^ 1) * S::MAT, fx, fy, fo);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
            if (expo[j] >> p & 1) at[j] = at[j] < 0 ? 0 : at[j] ^ 1;
        __syncthreads();
        cur ^= 1;
        DESIGN_STAMP(4 + p);  // design: pass +
    }

    DESIGN_STAMP(35);  // design: chain done
    // Each power (the identity where its exponent is 0).
    const double* P[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        double* buf = mats + S::RUN + 2 * j * S::MAT;
        if (at[j] < 0) {
            for (int idx = threadIdx.x; idx < D; idx += blockDim.x)
                buf[idx * S::LD + idx] = 1.0;
            at[j] = 0;
        }
        P[j] = buf + at[j] * S::MAT;
    }
    __syncthreads();

    const double* Bv = vals + 1;
    const double* Cv = vals + 1 + D;
    if (table == 0) {
        // group_in[U-1-u] = A^u B, group_out[:, u] = C A^u, then seq[u] =
        // C A^u B on fir_t's diagonal u + 1 (the plain version's sums).
        for (int idx = threadIdx.x; idx < mine * 2 * D; idx += blockDim.x) {
            const int j = idx / (2 * D), e = idx % (2 * D);
            const int u = j ? other : b;
            const double* X = j ? P[1] : P[0];          // A^u
            double acc = 0.0;
            if (e < D) {
#pragma unroll
                for (int k = 0; k < D; ++k)
                    acc = fma(X[e * S::LD + k], Bv[k], acc);
                group_in[(size_t)(geo.U - 1 - u) * D + e] = (float)acc;
            } else {
                const int c = e - D;
#pragma unroll
                for (int a = 0; a < D; ++a)
                    acc = fma(Cv[a], X[a * S::LD + c], acc);
                group_out[(size_t)c * geo.U + u] = (float)acc;
                ca[j][c] = acc;
            }
        }
        __syncthreads();
        const double dv = vals[0];
        for (int j = 0; j < mine; ++j) {
            const int u = j ? other : b;
            double s = 0.0;
#pragma unroll
            for (int c = 0; c < D; ++c) s = fma(ca[j][c], Bv[c], s);
            const float val = (float)__dadd_rn(s, __dmul_rn(dv, 0.0));
            for (int v = threadIdx.x; v < geo.U - 1 - u; v += blockDim.x)
                fir_t[(size_t)v * geo.U + v + 1 + u] = val;
        }
        if (b == 0) {
            // fir_t's main diagonal, D.
            const float val = (float)__dadd_rn(0.0, __dmul_rn(dv, 1.0));
            for (int v = threadIdx.x; v < geo.U; v += blockDim.x)
                fir_t[(size_t)v * geo.U + v] = val;
        }
    } else {
        // The power rounded to float32 once: transposed into tT for the
        // expand (tT[n][a][c] = P[c][a]), and pows_g / A_blk as it is.
        for (int idx = threadIdx.x; idx < mine * DD; idx += blockDim.x) {
            const int j = idx / DD, e = idx - j * DD, n = j ? other : b;
            const int a = e / D, c = e - a * D;
            const float v = (float)(j ? P[1] : P[0])[c * S::LD + a];
            tT[(size_t)(table == 1 ? n : geo.G + 1 + n) * DD + e] = v;
            if (table == 1 && n < geo.G) pows_g[(size_t)n * DD + c * D + a] = v;
            else if (table == 1) a_blk[c * D + a] = v;
        }
    }
    if (table == 0) DESIGN_STAMP(36);  // design: A's tables written
    if (table == 1) DESIGN_STAMP(38);  // design: Q's tables written
    if (table == 2) DESIGN_STAMP(39);  // design: R's powers written
}

// Row `row` of a block triangle (n d, n d) from its diagonal block on:
// block (v, r) = P_{r-v}^T, read from tT[base + r - v] (r >= v), W
// consecutive columns a thread step (one 16- or 8-byte load and store).
template <int W>
__device__ __forceinline__ void triangle_row(const float* __restrict__ tT,
                                             int base, int n, int d, int row,
                                             float* __restrict__ out)
{
    const int width = n * d;
    const int v = row / d, a = row - v * d;
    float* dst = out + (size_t)row * width;
    for (int col = v * d + threadIdx.x * W; col < width;
         col += blockDim.x * W) {
        const int r = col / d, c = col - r * d;
        const float* src = tT + ((size_t)(base + r - v) * d + a) * d + c;
        if (W == 4)
            *reinterpret_cast<float4*>(dst + col) =
                __ldg(reinterpret_cast<const float4*>(src));
        else
            *reinterpret_cast<float2*>(dst + col) =
                __ldg(reinterpret_cast<const float2*>(src));
    }
}

// A block a row of toe, then of carry_w, from its diagonal block on.  A
// programmatic dependent launch: it waits for the design grid (tT) before
// its first read.
template <int W>
__global__ void __launch_bounds__(EXPAND_THREADS)
eq_expand_f64_kernel(const float* __restrict__ tT, int d, int G, int K,
                     float* __restrict__ toe, float* __restrict__ carry)
{
    asm volatile("griddepcontrol.wait;" ::: "memory");
    DESIGN_STAMP(40);  // expand: design grid done
    const int rows_toe = G * d, rows = rows_toe + K * d;
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
        if (row < rows_toe)
            triangle_row<W>(tT, 0, G, d, row, toe);
        else
            triangle_row<W>(tT, G + 1, K, d, row - rows_toe, carry);
    }
    DESIGN_STAMP(41);  // expand: rows written
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

Geometry geometry(int nb, int U, int G, int K, double two_q,
                  double threshold)
{
    return Geometry{nb, U, G, K, two_q, threshold, pair_blocks(K),
                    pair_blocks(G + 1), pair_blocks(U)};
}

int design_grid(const Geometry& geo, int d)
{
    const int rows = (geo.G + geo.K) * d + geo.U;
    const int most = sm_count() * ZERO_BLOCKS_PER_SM;
    return geo.blocks_r + geo.blocks_q + geo.blocks_a
        + (rows < most ? rows : most);
}

template <int W>
cudaError_t launch_expand(const float* tT, int d, int G, int K, float* toe,
                          float* carry, cudaStream_t stream)
{
    const int rows = (G + K) * d;
    const int most = sm_count() * EXPAND_BLOCKS_PER_SM;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(rows < most ? rows : most);
    cfg.blockDim = dim3(EXPAND_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, eq_expand_f64_kernel<W>, tT, d, G, K,
                              toe, carry);
}

template <int D>
int launch_tables(const float* gains, const double* sin_w0,
                  const double* cos_w0, const Geometry& geo, float* group_in,
                  float* group_out, float* fir_t, float* toe, float* pows_g,
                  float* a_blk, float* carry, float* tT, cudaStream_t stream)
{
    eq_design_f64_kernel<D>
        <<<design_grid(geo, D), Shape<D>::THREADS, 0, stream>>>(
            gains, sin_w0, cos_w0, geo, group_in, group_out, fir_t, toe,
            pows_g, a_blk, carry, tT);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch_expand<Shape<D>::W>(tT, D, geo.G, geo.K, toe, carry,
                                     stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <int D>
int occupancy_of(int which, int* out)
{
    cudaFuncAttributes attr;
    int blocks = 0, threads = Shape<D>::THREADS;
    const void* fn = (const void*)eq_design_f64_kernel<D>;
    if (which == 1) {
        threads = EXPAND_THREADS;
        fn = Shape<D>::W == 4 ? (const void*)eq_expand_f64_kernel<4>
                              : (const void*)eq_expand_f64_kernel<2>;
    }
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                            threads, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = blocks;
    out[1] = attr.numRegs;
    out[2] = (int)attr.localSizeBytes;
    out[3] = (int)attr.sharedSizeBytes;
    out[4] = threads;
    return 0;
}

}  // namespace

extern "C" {

// The two kernels on `stream`; returns the first launch error (0 on
// success).  The caller (kernels/eq_design.py) checks the geometry and
// sizes every buffer: nb in 1..8, K = 0 without a dense carry (then
// `carry` is null), `tT` of (G + 1 + K) d d floats.
int eq_design_launch(const float* gains, const double* sin_w0,
                     const double* cos_w0, int nb, int U, int G, int K,
                     double two_q, double threshold, float* group_in,
                     float* group_out, float* fir_t, float* toe,
                     float* pows_g, float* a_blk, float* carry, float* tT,
                     void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Geometry geo = geometry(nb, U, G, K, two_q, threshold);
    switch (nb) {
#define TABLES_CASE(NB)                                                       \
    case NB:                                                                  \
        return launch_tables<2 * NB>(gains, sin_w0, cos_w0, geo, group_in,    \
                                     group_out, fir_t, toe, pows_g, a_blk,    \
                                     carry, tT, s);
        TABLES_CASE(1) TABLES_CASE(2) TABLES_CASE(3) TABLES_CASE(4)
        TABLES_CASE(5) TABLES_CASE(6) TABLES_CASE(7) TABLES_CASE(8)
#undef TABLES_CASE
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// The card's view of a kernel at nb bands (which: 0 the design kernel, 1
// the expand): out = {blocks an SM, registers and local (spilled) bytes a
// thread, static shared bytes and threads a block}.
int eq_design_occupancy(int which, int nb, int* out)
{
    switch (nb) {
#define OCC_CASE(NB) \
    case NB:         \
        return occupancy_of<2 * NB>(which, out);
        OCC_CASE(1) OCC_CASE(2) OCC_CASE(3) OCC_CASE(4)
        OCC_CASE(5) OCC_CASE(6) OCC_CASE(7) OCC_CASE(8)
#undef OCC_CASE
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// One call at (nb, U, G, K): out = {launches, design blocks (power
// blocks, then zero blocks), power blocks}.
int eq_design_grid(int nb, int U, int G, int K, int* out)
{
    if (nb < 1 || nb > MAX_BANDS) return (int)cudaErrorInvalidValue;
    const Geometry geo = geometry(nb, U, G, K, 0.0, 0.0);
    out[0] = 2;
    out[1] = design_grid(geo, 2 * nb);
    out[2] = geo.blocks_r + geo.blocks_q + geo.blocks_a;
    return 0;
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
