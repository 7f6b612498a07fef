// E2a, E2b and E7: the block-parallel IIR recurrence for Hopper, one
// group-algebra body in fp32 SIMT.
//
// Replaces the TPU kernels dsp_audio_project_tpu/kernels/experiments/iir.py:
// block_end_states (E2a, body _end_state_kernel) and block_apply (E2b, body
// _apply_kernel), and dsp_audio_project_tpu/kernels/experiments/iir_seq.py:
// equalize_seq_flat (E7, body _seq_kernel).  The EQ cascade is one order-d
// state-space system (s <- A s + B x_j, y_j = C s + D x_j).  A signal row
// is cut into K blocks of B samples (a "tile"), a tile into G groups of U
// samples, the last group ragged with r = B - (G-1) U samples.  Per group,
// with the tables the wrapper builds in float64 from the float32 system
// (kernels/experiments/iir_group.py):
//
//     h[k]     = D, C A^{k-1} B          the FIR taps (group_fir's column 0:
//                                        a lower-triangular Toeplitz matrix)
//     inj[g]   = sum_v A^{U-1-v} B x_v   the state injection (a ragged group:
//                                        the last r rows of that table)
//     s[g+1]   = A^U s[g] + inj[g]       Horner over the groups (A^r for the
//                                        ragged group); s[0] = sigma
//     y[g, u]  = sum_{k<=u} h[k] x_{u-k} + C A^u s[g]
//
// Three modes of the one body:
//
//     END   (E2a)  the end state of each tile from a zero state;
//     APPLY (E2b)  y of each tile from its true entry state sigma (given),
//                  optionally clipped to [-1, 1];
//     SEQ   (E7)   y, clipped, with sigma carried along each row: the tile
//                  publishes its zero-entry end state (its aggregate) as
//                  soon as the Horner pass has it, then resolves its entry
//                  state from a fixed window of W predecessors,
//                      sigma_k = sum_{j=1..W} A_blk^{j-1} agg_{k-j}
//                                + A_blk^W sigma_{k-W}
//                  (terms with k - j < 0 drop out; sigma_0 = 0), an
//                  identity of the carry, and publishes sigma_k.  The window
//                  is fixed, so the sum has the same terms in the same order
//                  on every run: the output is bitwise repeatable.  The
//                  chain along a row is K/W hops instead of K.
//
// What bounds it on an H100 (fp32 at 67 TFLOP/s, 3.35 TB/s).  Per sample the
// group algebra costs (U+1)/2 FIR multiply-adds, d for the injection, d for
// the readout and d*d/U for Horner; END only the last two.  At the serving
// shapes (d = 10, U = 128; E2: 2816 tiles of 8192; E7: 8 rows of 360 tiles
// of 8192) END moves 92 MB (0.028 ms, its bound), APPLY and SEQ 185-189 MB
// (0.055-0.056 ms) against ~85 multiply-adds a sample (0.059-0.060 ms, their
// bound); the earlier per-sample recurrence ran 8192 dependent steps a tile.
// What holds the body back is latency: each tile's phases run one after
// the other, and the Horner pass is a chain of dependent d x d steps.
//
// Design: a CTA of 4 FIR warps (END: 3 load and injection warps) and one
// serial warp takes one tile (END, APPLY: one CTA a tile, the tile in
// chunks of up to CHUNK groups; SEQ: a persistent grid that takes tiles
// from an atomic ticket in k-major order, so every predecessor of a tile
// was taken earlier by a resident CTA, the whole tile in shared memory).
// Per chunk:
//   A. x into shared memory (float4 loads where the rows allow; zeros past
//      the signal), one group a row of U + 1 floats (lanes on distinct
//      banks);
//   B. inj by all threads: lane = group, the table row a broadcast, two
//      halves of the group summed after;
//   C. the serial warp runs Horner in 32 // d segments at once (lane group
//      j, lane e: s[e] of segment j and row e of A^U, shuffles between
//      steps), chains the segments' entry states through A^{L U} and takes
//      one step to the chunk's end state; in SEQ it publishes that (the
//      aggregate) and resolves sigma by the look-back (one lane per
//      predecessor); the FIR warps meanwhile compute y0 = the triangular
//      Toeplitz product: lane = group, R = 8 consecutive outputs in
//      registers, taps as float4 broadcasts, x a sliding window in
//      registers, the zero upper triangle skipped at compile time;
//   D. each group's true entry state, local + A^{(g - jL) U} T_j (all
//      threads), then the readout y = y0 + s_true . C A^u, clipped where
//      asked, float4 stores.
// d is a template parameter (the even orders 2..12: one biquad band adds two
// states).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U = 128;                 // group length
constexpr int R = 8;                   // FIR outputs a thread keeps
constexpr int RUNS = U / R;
constexpr int FIR_WARPS = 4;           // APPLY, SEQ: 4 FIR warps + the serial warp
constexpr int END_WARPS = 3;           // END: 3 load/injection warps + the serial warp
constexpr int XS = U + 1;              // x row stride: odd, lanes on distinct banks
constexpr int YS = U + 4;              // y0 row stride: 16-byte rows
constexpr int CHUNK = 32;              // groups a chunk (END, APPLY)
constexpr int PAY = 16;                // 64-bit words a published vector
constexpr int MAX_W = 31;              // look-back lanes 1..W, lane 0 sigma
constexpr unsigned FULL = 0xffffffffu;

enum Mode { END = 0, APPLY = 1, SEQ = 2 };

// The CTA of a mode: its warps, the last of them the serial warp.
template <int MODE> struct Shape {
    static constexpr int serial = MODE == END ? END_WARPS : FIR_WARPS;
    static constexpr int threads = (serial + 1) * 32;
    static constexpr int min_ctas = MODE == END ? 6 : 4;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int gin_stride(int d) { return round4(d); }
__host__ __device__ constexpr int pw_stride(int d) { return d * d + 1; }

// Offsets (floats) into the global table, which the wrapper builds in this
// order: h (U) | gin (U, gin_stride) | gout (d, U) | A^U (d, d) | A^r (d, d)
// | A_blk^j, j = 0..W (W+1, d, d) | A^{gU}, g = 0..G-1 (G, d, d).
struct TabLayout {
    int h, gin, gout, au, ar, pw, pows;
    __host__ __device__ TabLayout(int d, int W) {
        h = 0;
        gin = h + U;
        gout = gin + U * gin_stride(d);
        au = gout + d * U;
        ar = au + d * d;
        pw = ar + d * d;
        pows = pw + (W + 1) * d * d;
    }
};

// Offsets (floats) into shared memory for a chunk of cg groups.
struct SmemLayout {
    int h, gin, gout, pw, xs, y0, inj, st, seg, total;
    __host__ __device__ SmemLayout(int d, int mode, int cg, int W) {
        const int is = d + 1;
        h = 0;
        gin = h + U;
        gout = gin + U * gin_stride(d);
        pw = gout + d * U;
        xs = pw + (mode == SEQ ? round4((W + 1) * pw_stride(d)) : 0);
        y0 = xs + round4(cg * XS);
        inj = y0 + (mode == END ? 0 : cg * YS);
        st = inj + round4(2 * cg * is);
        seg = st + round4(cg * is);
        total = seg + 64;
    }
};

// E7's published vectors: each component a 64-bit word {value, 1} written
// in one store, so a reader that sees the tag sees the value (the scratch
// is zeroed before the launch), with no fence on either side.
__device__ __forceinline__ void publish(unsigned long long* p, float v)
{
    const unsigned long long w = (1ull << 32) | __float_as_uint(v);
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" :: "l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* p)
{
    unsigned long long w;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
    return w;
}

// Wait for a published vector: poll one word (light on L2), then read all
// d and check every tag.
template <int D>
__device__ __forceinline__ void wait_vector(const unsigned long long* p, float (&v)[D])
{
    unsigned long long w[D];
    for (;;) {
        if (peek(p + D - 1) >> 32) {
            unsigned ready = 1;
#pragma unroll
            for (int f = 0; f < D; ++f) {
                w[f] = peek(p + f);
                ready &= (unsigned)(w[f] >> 32);
            }
            if (ready) break;
        }
        __nanosleep(32);
    }
#pragma unroll
    for (int f = 0; f < D; ++f) v[f] = __uint_as_float((unsigned)w[f]);
}

__device__ __forceinline__ float clip1(float v)
{
    return fminf(fmaxf(v, -1.f), 1.f);
}

// On the serial warp: lane e returns (m v)[e] + add, where lane f < d holds
// v[f] and m is row e of the matrix.
template <int D>
__device__ __forceinline__ float matvec(const float (&m)[D], float v, float add)
{
    float t0 = add, t1 = 0.f;
#pragma unroll
    for (int f = 0; f < D; f += 2) {
        t0 = fmaf(m[f], __shfl_sync(FULL, v, f), t0);
        t1 = fmaf(m[f + 1], __shfl_sync(FULL, v, f + 1), t1);
    }
    return t0 + t1;
}

// y0[g, u0 .. u0+R) = sum_{k <= u} h[k] x[g, u-k]: lane = group g (xg its
// row), the taps broadcast.  A block of R taps takes R new x values into a
// sliding window; the last block (k from u0) skips the zero triangle.
__device__ __forceinline__ void fir_run(const float* __restrict__ xg,
                                        const float* __restrict__ h_s,
                                        int u0, float (&acc)[R])
{
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    float cur[R];                       // cur[m] = x[u0 - kb + m]
#pragma unroll
    for (int m = 0; m < R; ++m) cur[m] = xg[u0 + m];
#pragma unroll 2
    for (int kb = 0; kb < u0; kb += R) {
        float prev[R];                  // prev[m] = x[u0 - kb - R + m]
#pragma unroll
        for (int m = 0; m < R; ++m) prev[m] = xg[u0 - kb - R + m];
        const float4 h0 = *reinterpret_cast<const float4*>(h_s + kb);
        const float4 h1 = *reinterpret_cast<const float4*>(h_s + kb + 4);
        const float hk[R] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int t = 0; t < R; ++t)
#pragma unroll
            for (int r = 0; r < R; ++r)
                acc[r] = fmaf(hk[t], r >= t ? cur[r - t] : prev[R + r - t], acc[r]);
#pragma unroll
        for (int m = 0; m < R; ++m) cur[m] = prev[m];
    }
    const float4 h0 = *reinterpret_cast<const float4*>(h_s + u0);
    const float4 h1 = *reinterpret_cast<const float4*>(h_s + u0 + 4);
    const float hk[R] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int t = 0; t < R; ++t)
#pragma unroll
        for (int r = t; r < R; ++r)
            acc[r] = fmaf(hk[t], cur[r - t], acc[r]);
}

struct Args {
    const float* x;        // rows of `ld` floats, n_row valid samples each
    const float* sigma;    // APPLY: (rows*K, d) entry states
    float* out;            // END: (rows*K, d); APPLY, SEQ: rows of `ldy`
    const float* tab;      // the global table (TabLayout)
    unsigned long long* pub;   // SEQ, zeroed: the ticket, then 2 vectors of
                               // PAY words a tile (aggregate, sigma)
    int rows, K, B, G, CG, W;
    int64_t ld, ldy, n_row;
    int vec;               // ld, ldy, B multiples of 4, x and out 16-byte aligned
    int clip;
};

template <int D, int MODE>
__global__ void __launch_bounds__(Shape<MODE>::threads, Shape<MODE>::min_ctas)
iir_group_kernel(const Args a)
{
    constexpr int IS = D + 1;
    constexpr int GS = gin_stride(D);
    constexpr int SEGS = 32 / D;          // the serial warp's lane groups
    constexpr int THREADS = Shape<MODE>::threads;
    constexpr int SERIAL = Shape<MODE>::serial;
    extern __shared__ __align__(16) float smem[];
    const SmemLayout L(D, MODE, a.CG, a.W);
    const TabLayout T(D, a.W);
    float* h_s = smem + L.h;
    float* gin_s = smem + L.gin;
    float* gout_s = smem + L.gout;
    float* pw_s = smem + L.pw;
    float* xs = smem + L.xs;
    float* y0s = smem + L.y0;
    float* inj_s = smem + L.inj;
    float* st_s = smem + L.st;
    float* seg_s = smem + L.seg;          // segments' zero-entry ends
    float* segT_s = seg_s + 32;           // segments' entry states
    __shared__ int tile_s;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    for (int i = tid; i < U; i += THREADS) h_s[i] = __ldg(a.tab + T.h + i);
    for (int i = tid; i < U * GS; i += THREADS) gin_s[i] = __ldg(a.tab + T.gin + i);
    if (MODE != END)
        for (int i = tid; i < D * U; i += THREADS) gout_s[i] = __ldg(a.tab + T.gout + i);
    if (MODE == SEQ)
        for (int i = tid; i < (a.W + 1) * D * D; i += THREADS)
            pw_s[i / (D * D) * pw_stride(D) + i % (D * D)] = __ldg(a.tab + T.pw + i);
    const int rag = a.B - (a.G - 1) * U;          // samples in the last group
    const int tiles = a.rows * a.K;

    for (int t = (MODE == SEQ) ? -1 : (int)blockIdx.x;;) {
        if (MODE == SEQ) {
            __syncthreads();                      // the last tile is done
            if (tid == 0) tile_s = (int)atomicAdd(a.pub, 1ull);
            __syncthreads();
            t = tile_s;
            if (t >= tiles) break;
        }
        // SEQ takes tiles k-major; END and APPLY one tile a CTA, row-major.
        const int k = (MODE == SEQ) ? t / a.rows : t % a.K;
        const int row = (MODE == SEQ) ? t - k * a.rows : t / a.K;
        const int64_t tile = (int64_t)row * a.K + k;
        const int64_t base = (int64_t)row * a.ld + (int64_t)k * a.B;
        const int64_t obase = (int64_t)row * a.ldy + (int64_t)k * a.B;
        const int64_t left = a.n_row - (int64_t)k * a.B;
        const int valid = (int)(left < a.B ? (left > 0 ? left : 0) : a.B);

        float s = 0.f;                            // serial lane e: s[e]
        if (MODE == APPLY && warp == SERIAL && lane < D)
            s = __ldg(a.sigma + tile * D + lane);

        for (int c0 = 0; c0 < a.G; c0 += a.CG) {
            const int cg = min(a.CG, a.G - c0);
            const int n0 = c0 * U;
            const int nv = min(cg * U, valid - n0);   // may be <= 0
            __syncthreads();                      // the last chunk's readers

            // A. x of the chunk, zeros past the signal.
            const float* xc = a.x + base + n0;
            if (a.vec) {
                for (int i0 = 4 * tid; i0 < cg * U; i0 += 4 * 4 * THREADS) {
                    float4 v[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int i = i0 + 4 * q * THREADS;
                        v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
                        if (i + 3 < nv) {
                            v[q] = __ldcs(reinterpret_cast<const float4*>(xc + i));
                        } else if (i < nv) {
                            v[q].x = __ldcs(xc + i);
                            if (i + 1 < nv) v[q].y = __ldcs(xc + i + 1);
                            if (i + 2 < nv) v[q].z = __ldcs(xc + i + 2);
                        }
                    }
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int i = i0 + 4 * q * THREADS;
                        if (i < cg * U) {
                            float* dst = xs + (i / U) * XS + i % U;
                            dst[0] = v[q].x; dst[1] = v[q].y;
                            dst[2] = v[q].z; dst[3] = v[q].w;
                        }
                    }
                }
            } else {
                for (int i = tid; i < cg * U; i += THREADS)
                    xs[(i / U) * XS + i % U] = i < nv ? __ldcs(xc + i) : 0.f;
            }
            __syncthreads();

            // B. inj[g] = x_g @ gin, two halves of the group per group.
            for (int it = tid; it < 2 * cg; it += THREADS) {
                const int g = it % cg, part = it / cg;
                // The ragged group's r samples meet the table's last r rows.
                const int off = (c0 + g == a.G - 1) ? U - rag : 0;
                const float* xg = xs + g * XS - off;
                float acc[GS];
#pragma unroll
                for (int e = 0; e < GS; ++e) acc[e] = 0.f;
                const int v0 = part * (U / 2);
#pragma unroll 4
                for (int v = v0; v < v0 + U / 2; ++v) {
                    const float xv = v >= off ? xg[v] : 0.f;
#pragma unroll
                    for (int q = 0; q < GS / 4; ++q) {
                        const float4 w = *reinterpret_cast<const float4*>(gin_s + v * GS + 4 * q);
                        acc[4 * q] = fmaf(xv, w.x, acc[4 * q]);
                        acc[4 * q + 1] = fmaf(xv, w.y, acc[4 * q + 1]);
                        acc[4 * q + 2] = fmaf(xv, w.z, acc[4 * q + 2]);
                        acc[4 * q + 3] = fmaf(xv, w.w, acc[4 * q + 3]);
                    }
                }
                float* dst = inj_s + part * cg * IS + g * IS;
#pragma unroll
                for (int e = 0; e < D; ++e) dst[e] = acc[e];
            }
            __syncthreads();

            // C. Horner on the serial warp; the FIR product on the others.
            // Horner segments of Lg groups, the last one shorter, none empty.
            const int Lg = (cg + min(SEGS, cg) - 1) / min(SEGS, cg);
            const int S = (cg + Lg - 1) / Lg;
            if (warp == SERIAL) {
                const int j = lane / D, e = lane - j * D;
                const bool on = j < S;
                // Rows e of A^U, of A^{Lg U}, of A^{(gl - (S-1) Lg) U}, which
                // carries the last segment's entry state to the chunk's last
                // group gl, and of gl's step (A^r for the block's ragged last
                // group), all loaded before the Horner pass.
                const int gl = cg - 1;
                float au[D], al[D], pr[D], mr[D];
#pragma unroll
                for (int f = 0; f < D; ++f) {
                    au[f] = __ldg(a.tab + T.au + e * D + f);
                    al[f] = S > 1 ? __ldg(a.tab + T.pows + (Lg * D + e) * D + f) : 0.f;
                    pr[f] = __ldg(a.tab + T.pows + ((gl - (S - 1) * Lg) * D + e) * D + f);
                    mr[f] = __ldg(a.tab + (c0 + gl == a.G - 1 ? T.ar : T.au) + e * D + f);
                }
                // 1. Lane group j runs segment j from a zero state: each
                //    group's local entry state, then the segment's end (the
                //    last segment's end goes unused, so its steps all take
                //    A^U).
                float sl = 0.f;
#pragma unroll 2
                for (int i = 0; i < Lg; ++i) {
                    const int g = j * Lg + i;
                    const bool live = on && g < cg;
                    float inj = 0.f;
                    if (live) {
                        st_s[g * IS + e] = sl;
                        inj = inj_s[g * IS + e] + inj_s[(cg + g) * IS + e];
                    }
                    float t0 = 0.f, t1 = 0.f;
#pragma unroll
                    for (int f = 0; f < D; f += 2) {
                        t0 = fmaf(au[f], __shfl_sync(FULL, sl, j * D + f), t0);
                        t1 = fmaf(au[f + 1], __shfl_sync(FULL, sl, j * D + f + 1), t1);
                    }
                    if (live) sl = (t0 + t1) + inj;
                }
                if (on) seg_s[lane] = sl;
                __syncwarp();
                // 2. Lanes 0..d-1: the segments' entry states, T_0 = the
                //    chunk's (s), T_j = A^{Lg U} T_{j-1} + end_{j-1}.
                float tj = s;
                if (lane < D) segT_s[lane] = tj;
                for (int jj = 1; jj < S; ++jj) {
                    tj = matvec<D>(al, tj, lane < D ? seg_s[(jj - 1) * D + lane] : 0.f);
                    if (lane < D) segT_s[jj * D + lane] = tj;
                }
                // 3. The chunk's end: one step from its last group's entry
                //    state (local + A^{(g - jL) U} T_j).
                {
                    const bool own = lane < D;
                    const float stl = matvec<D>(pr, tj, own ? st_s[gl * IS + lane] : 0.f);
                    s = matvec<D>(mr, stl, own ? inj_s[gl * IS + lane]
                                                 + inj_s[(cg + gl) * IS + lane] : 0.f);
                }
                if (MODE == SEQ) {
                    // s is the block's zero-entry end state: publish it,
                    // resolve sigma_k from the window, publish that.
                    unsigned long long* slots = a.pub + 1 + 2 * tile * PAY;
                    if (lane < D) publish(slots + lane, s);
                    // Lane j in 1..W: agg_{k-j} through A_blk^{j-1}; lane 0:
                    // sigma_{k-W} through A_blk^W.
                    const int jw = lane ? lane : a.W;
                    const bool take = (lane ? lane <= a.W : true) && k - jw >= 0;
                    float v[D];
#pragma unroll
                    for (int f = 0; f < D; ++f) v[f] = 0.f;
                    if (take) {
                        const unsigned long long* src =
                            a.pub + 1 + (2 * (tile - jw) + (lane ? 0 : 1)) * PAY;
                        wait_vector<D>(src, v);
                    }
                    const float* P = pw_s + (lane ? lane - 1 : a.W) * pw_stride(D);
                    float term[D];
#pragma unroll
                    for (int r = 0; r < D; ++r) {
                        float acc = 0.f;
                        if (take) {
#pragma unroll
                            for (int f = 0; f < D; ++f) acc = fmaf(P[r * D + f], v[f], acc);
                        }
                        term[r] = acc;
                    }
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
                        for (int r = 0; r < D; ++r)
                            term[r] += __shfl_xor_sync(FULL, term[r], o);
                    float sig = 0.f;              // lane e: sigma_k[e]
#pragma unroll
                    for (int r = 0; r < D; ++r)
                        if (lane == r) sig = term[r];
                    if (lane < D) publish(slots + PAY + lane, sig);
                    // The segments' true entry states: T_j + A^{j Lg U} sigma_k.
                    for (int jj = 0; jj < S; ++jj) {
                        float pr[D];
#pragma unroll
                        for (int f = 0; f < D; ++f)
                            pr[f] = __ldg(a.tab + T.pows + (jj * Lg * D + e) * D + f);
                        const float t = matvec<D>(pr, sig, lane < D ? segT_s[jj * D + lane] : 0.f);
                        if (lane < D) segT_s[jj * D + lane] = t;
                    }
                }
            } else if (MODE != END) {
                const int pairs = (cg + 31) / 32 * (RUNS / 2);
                for (int p = warp; p < pairs; p += SERIAL) {
                    const int g = (p / (RUNS / 2)) * 32 + lane;
                    const float* xg = xs + min(g, cg - 1) * XS;
#pragma unroll 1
                    for (int h = 0; h < 2; ++h) {
                        const int run = h ? RUNS - 1 - p % (RUNS / 2) : p % (RUNS / 2);
                        float acc[R];
                        fir_run(xg, h_s, run * R, acc);
                        if (g < cg) {
                            float4* dst = reinterpret_cast<float4*>(y0s + g * YS + run * R);
                            dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
                            dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
                        }
                    }
                }
            }
            if (MODE == END) continue;
            __syncthreads();

            // Each group's true entry state: local + A^{(g - jL) U} T_j.
            for (int i = tid; i < cg * D; i += THREADS) {
                const int g = i / D, e = i - g * D, jj = g / Lg;
                const float* p = a.tab + T.pows + ((int64_t)(g - jj * Lg) * D + e) * D;
                float acc = st_s[g * IS + e];
#pragma unroll
                for (int f = 0; f < D; ++f) acc = fmaf(__ldg(p + f), segT_s[jj * D + f], acc);
                st_s[g * IS + e] = acc;
            }
            __syncthreads();

            // D. y = y0 + s_true . C A^u, clipped where asked.
            float* yc = a.out + obase + n0;
            const bool clip = MODE == SEQ || a.clip;
            for (int i = tid; i < cg * (U / 4); i += THREADS) {
                const int g = i / (U / 4), u = 4 * (i - g * (U / 4));
                const int n = g * U + u;
                if (n >= nv) continue;
                float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                for (int e = 0; e < D; ++e) {
                    const float sv = st_s[g * IS + e];
                    const float4 w = *reinterpret_cast<const float4*>(gout_s + e * U + u);
                    acc.x = fmaf(sv, w.x, acc.x);
                    acc.y = fmaf(sv, w.y, acc.y);
                    acc.z = fmaf(sv, w.z, acc.z);
                    acc.w = fmaf(sv, w.w, acc.w);
                }
                const float4 y0 = *reinterpret_cast<const float4*>(y0s + g * YS + u);
                acc.x += y0.x; acc.y += y0.y; acc.z += y0.z; acc.w += y0.w;
                if (clip) {
                    acc.x = clip1(acc.x); acc.y = clip1(acc.y);
                    acc.z = clip1(acc.z); acc.w = clip1(acc.w);
                }
                if (a.vec && n + 3 < nv) {
                    __stcs(reinterpret_cast<float4*>(yc + n), acc);
                } else {
                    yc[n] = acc.x;
                    if (n + 1 < nv) yc[n + 1] = acc.y;
                    if (n + 2 < nv) yc[n + 2] = acc.z;
                    if (n + 3 < nv) yc[n + 3] = acc.w;
                }
            }
        }
        if (MODE == END && warp == SERIAL && lane < D) a.out[tile * D + lane] = s;
        if (MODE != SEQ) break;
    }
}

template <int D, int MODE>
int launch_mode(Args a, cudaStream_t stream)
{
    auto kern = iir_group_kernel<D, MODE>;
    const size_t smem = (size_t)SmemLayout(D, MODE, a.CG, a.W).total * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (long long)a.rows * a.K;
    long long grid = tiles;
    if (MODE == SEQ) {
        // Persistent: every CTA resident, so a tile's predecessors (taken
        // earlier from the ticket) always make progress.
        int dev = 0, sms = 0, per_sm = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            Shape<MODE>::threads, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        grid = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
    }
    kern<<<(unsigned)grid, Shape<MODE>::threads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

int launch(int mode, Args a, int d, cudaStream_t stream)
{
    if (a.rows < 0 || a.K < 0 || a.B < 1 || a.W < 1 || a.W > MAX_W)
        return (int)cudaErrorInvalidValue;
    const long long tiles = (long long)a.rows * a.K;
    if (tiles == 0) return 0;
    if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    a.G = (a.B + U - 1) / U;
    a.CG = mode == SEQ ? a.G : (a.G < CHUNK ? a.G : CHUNK);
    const uintptr_t mis = (reinterpret_cast<uintptr_t>(a.x)
                           | reinterpret_cast<uintptr_t>(a.out)) & 15;
    a.vec = a.ld % 4 == 0 && a.ldy % 4 == 0 && a.B % 4 == 0 && !mis;
#define IIR_MODES(DD)                                                       \
    case DD:                                                                \
        return mode == END ? launch_mode<DD, END>(a, stream)                \
             : mode == APPLY ? launch_mode<DD, APPLY>(a, stream)            \
             : launch_mode<DD, SEQ>(a, stream);
    switch (d) {
    IIR_MODES(2)
    IIR_MODES(4)
    IIR_MODES(6)
    IIR_MODES(8)
    IIR_MODES(10)
    IIR_MODES(12)
    default: return (int)cudaErrorInvalidValue;
    }
#undef IIR_MODES
}

}  // namespace

extern "C" {

// The kernels' group length: the wrapper builds its tables at it.
int iir_group_length() { return U; }

// Largest block SEQ takes: the whole tile is in shared memory.
int iir_seq_max_block(int d, int W)
{
    int dev = 0, limit = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    int G = 1;
    while ((size_t)SmemLayout(d, SEQ, G + 1, W).total * sizeof(float) <= (size_t)limit) ++G;
    return G * U;
}

// E2a: end (rows*K, d), the zero-state end state of each block of B samples
// of x (rows of ld floats, n_row valid, zeros past them).  `tab`: the
// device table (TabLayout, W = 1).  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int iir_end_states_launch(const float* x, float* end, const float* tab,
                          int rows, int K, long long ld, long long n_row,
                          int B, int d, void* stream)
{
    Args a = {};
    a.x = x; a.out = end; a.tab = tab;
    a.rows = rows; a.K = K; a.B = B; a.W = 1; a.ld = ld; a.ldy = 0;
    a.n_row = n_row;
    return launch(END, a, d, static_cast<cudaStream_t>(stream));
}

// E2b: y (rows of ldy floats, the first n_row written) from x (rows of ld
// floats) and sigma (rows*K, d); clipped to [-1, 1] when `clip`.
int iir_apply_launch(const float* x, const float* sigma, float* y,
                     const float* tab, int rows, int K, long long ld,
                     long long ldy, long long n_row, int B, int d, int clip,
                     void* stream)
{
    Args a = {};
    a.x = x; a.sigma = sigma; a.out = y; a.tab = tab;
    a.rows = rows; a.K = K; a.B = B; a.W = 1; a.ld = ld; a.ldy = ldy;
    a.n_row = n_row;
    a.clip = clip;
    return launch(APPLY, a, d, static_cast<cudaStream_t>(stream));
}

// E7: y (rows, K*B), clipped, from x (rows, K*B), the state carried along
// each row.  `tab`: the device table with W look-back powers.  Scratch: pub
// (1 + 2*rows*K*16 64-bit words, zeroed by the caller).
int iir_seq_launch(const float* x, float* y, const float* tab, void* pub,
                   int rows, int K, int B, int d, int W, void* stream)
{
    Args a = {};
    a.x = x; a.out = y; a.tab = tab;
    a.pub = static_cast<unsigned long long*>(pub);
    a.rows = rows; a.K = K; a.B = B; a.W = W;
    a.ld = (long long)K * B; a.ldy = a.ld; a.n_row = a.ld;
    return launch(SEQ, a, d, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
