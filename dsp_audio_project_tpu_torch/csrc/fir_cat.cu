// K1 (EQ-fused polyphase FIR, "cat" FIR) and the frames FIR (K3-K6, E1,
// E3-E5) for Hopper's tensor cores: one kernel body, two launchers.
//
// fir_cat_launch replaces the TPU kernel dsp_audio_project_tpu/kernels/
// fir_class.py:polyphase_fir_class_rect_cat (body _class_rect_cat_kernel).
// It computes, for batch row b and frame f < f_pad,
//
//     [y0 | inj][b, f, :] = sum_w x_pad[b, f*s + w] * G2[w, :]      (w < W)
//
// with x_pad = zeros(pad_left) ++ x ++ zeros (x reads as 0 outside [0, n))
// and G2 = G @ [group_fir^T | group_in] (W, V = P + d), composed in float64
// on the host.  Columns [0, P) go to y0 (B, f_pad, P), columns [P, V) to
// inj (B, f_pad, d), unpacked.  The TPU kernel's 128 residue classes,
// pre-rotated banks, DPAD packing and virtual-row rectangles exist only to
// fit TPU lanes and VMEM; none of them is needed here.
//
// fir_frames_launch runs the same body with V = P (G instead of G2, no inj
// columns, so the inj store is never reached): y[b, f, :] = x_pad[b, f*s :
// f*s + W] @ G.  It replaces fir_class.py:polyphase_fir_class_rect_frames
// (K3), polyphase_fir_class_frames (K4), polyphase_fir_class_flat (K6; the
// row-major (F, P) frames are the flat signal), fir_shear.py:
// polyphase_fir_shear_frames (K5), experiments/fir.py:polyphase_fir (E1)
// and the E3-E5 stagings: one function staged many ways for the TPU.  Any
// stride s works here; the wrappers keep the TPU routes' ValueErrors so the
// contract matches.
//
// What bounds it on an H100, at the serving shape (L/M = 160/147: P = 160,
// s = 147, W = 187, d = 10, batch 8 x 60 s, f_pad = 18432): at fp32
// accuracy, 147,456 frames x 187 taps x 170 columns as three TF32 products
// (28.1 GFLOP, 57 us at 495 TFLOP/s dense TF32) against about 185 MB moved
// (x 84.7 MB read, y0 94.4 MB and inj 5.9 MB written: 55 us at 3.35 TB/s).
// The two bounds meet; the fp32 SIMT units (67 TFLOP/s, 140 us for the same
// work as FMAs) cannot reach either, so the products run on the tensor cores.
//
// Design:
// * Products: warp-level mma.sync m16n8k8 TF32 with fp32 accumulators.  Each
//   operand splits into hi = rna_tf32(v) and lo = rna_tf32(v - hi), the
//   rounding of cvt.rna.tf32.f32 done as two integer ops on the bits (the
//   compiler cannot fold v - hi to 0 through them; the build has no
//   --use_fast_math), and each 8-tap step sums a_lo b_hi + a_hi b_lo +
//   a_hi b_hi, small terms first, in a fresh accumulator that is then added
//   to the running one in fp32: an mma truncates its sum at the exponent of
//   its largest addend, so with the running sum as its C operand it would
//   drop the products' low bits at every step, which costs most where the
//   outputs cancel (the inj columns of K1).  3xTF32 so summed keeps
//   the fp32 result (kernels/fir_class.py mirrors the split as tf32_split)
//   and serves src_fast = True and False, as before.
// * A, the window matrix A[f, w] = x_pad[f*s + w], is never materialised.
//   A block owns BM consecutive frames of one batch row and 96 columns.  It
//   copies the one contiguous span of x its frames read, x_pad[f0*s] ..
//   x_pad[(f0 + BM - 1)*s + W), into shared memory once with cp.async:
//   16-byte copies on 16-byte-aligned runs (the span sits in shared memory
//   at the same offset mod 4 as in device memory), 4-byte copies and zeros
//   at the edges of [0, n).  Fragments read xs[(f - f0)*s + w] and split in
//   registers.  BM = 64 frames where that span fits 96 KB (s up to ~370 at
//   W ~ 1.3 s; 37.8 KB at 160/147), else 32 (110.5 KB -> 56.7 KB at
//   320/441).  A stride too wide for either streams the windows instead:
//   BM rows x 16 taps a chunk, 4-byte cp.async, row stride 20 (any s, W).
// * B, G or G2, streams in 16-tap chunks through two shared buffers with
//   cp.async (4-byte: rows of 170 columns are not 16-byte aligned), the
//   next chunk in flight while the current one is multiplied, and splits in
//   registers.  Taps past W and columns past V read as zero, and a warp
//   skips its n-tiles past V.  A row stride of 104 floats (8 mod 32) keeps
//   the B fragments on distinct banks.
// * Warps: 2 x 2, each 16*MT frames x 48 columns (MT m-tiles x 6 n-tiles,
//   MT*24 fp32 accumulators a thread); 4 blocks share an SM at 160/147
//   (51 KB of shared memory, <= 128 registers).  A fragments read 8 frames
//   at stride s: at s = 147 (19 mod 32) a few banks are hit twice.
// * Epilogue: the accumulator tile goes through shared memory (sized to
//   hold it) so that each frame's columns leave as coalesced runs (16-byte
//   stores where P % 4 == 0), y0 columns [0, P), inj columns [P, V).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_M = 2, WARPS_N = 2;
constexpr int NWARPS = WARPS_M * WARPS_N;
constexpr int THREADS = 32 * NWARPS;    // 128
constexpr int MIN_BLOCKS = 4;           // per SM: at most 128 registers
constexpr int NT = 6;                   // 8-column n-tiles per warp
constexpr int BN = WARPS_N * NT * 8;    // 96 columns per block
constexpr int BK = 16;                  // taps per chunk
constexpr int LDB = BN + 8;             // B chunk row stride (8 mod 32)
constexpr int LDA = BK + 4;             // streamed-window row stride (20 mod 32)
constexpr int LDC = BN + 4;             // epilogue tile row stride
constexpr int B_TILE = BK * LDB;        // floats per B buffer
static_assert(BN % 32 == 0 && BK % NWARPS == 0 && BK % 8 == 0, "loaders");
constexpr int SPAN_MAX_BYTES = 96 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte copy, or zero fill when !ok (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest has landed (this thread's copies).
__device__ __forceinline__ void cp_async_wait_prev()
{
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// cvt.rna.tf32.f32 on a finite v: the magnitude rounded at bit 13, ties
// away from zero, in two integer ops (the cvt instruction itself lowers to
// ~5, for its NaN and infinity cases).
__device__ __forceinline__ uint32_t tf32_rna(float v)
{
    return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo)
{
    hi = tf32_rna(v);
    lo = tf32_rna(v - __uint_as_float(hi));
}

// c += a b on one 16 x 8 x 8 tile (PTX fragment layouts of m16n8k8 tf32).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// SPAN: the block's whole span of x in shared memory (`span` floats);
// else BM x BK windows per chunk, double-buffered like B.
template <int MT, bool SPAN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fir_tf32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                float* __restrict__ y0, float* __restrict__ inj,
                int n, int f_out, int W, int V, int P, int s, int pad_left,
                int nfb, int ncb, int span)
{
    constexpr int BM = WARPS_M * 16 * MT;
    extern __shared__ __align__(16) float smem[];
    float* bs = smem;                       // [2][BK][LDB]
    float* xs = smem + 2 * B_TILE;          // span, or [2][BM][LDA]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gq = lane >> 2, tq = lane & 3;        // fragment row / column
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    // Column blocks fastest, so the blocks that share a span run together.
    const int cb = blockIdx.x % ncb;
    const int fb = (blockIdx.x / ncb) % nfb;
    const int b = blockIdx.x / ncb / nfb;
    const int f0 = fb * BM, c0 = cb * BN;
    const float* xb = x + (int64_t)b * n;
    const int64_t gx0 = (int64_t)f0 * s - pad_left;   // x index of (f0, tap 0)
    const int chunks = (W + BK - 1) / BK;

    // B chunk kc: warp w stages taps w, w + NWARPS, ..., lane c the columns
    // c, c + 32, ... (coalesced runs; the bounds per column are fixed).
    const float* gcol = g + c0 + lane;
    bool col_ok[BN / 32];
#pragma unroll
    for (int u = 0; u < BN / 32; ++u) col_ok[u] = c0 + lane + 32 * u < V;
    auto load_b = [&](int kc, int buf) {
        float* dst = bs + buf * B_TILE + lane;
#pragma unroll
        for (int r = 0; r < BK / NWARPS; ++r) {
            const int k = warp + NWARPS * r, w = kc * BK + k;
#pragma unroll
            for (int u = 0; u < BN / 32; ++u) {
                const bool ok = w < W && col_ok[u];
                cp_async4(dst + k * LDB + 32 * u,
                          ok ? gcol + (int64_t)w * V + 32 * u : g, ok);
            }
        }
    };
    // Streamed windows, chunk kc: thread e of each pass stages frame e / BK,
    // tap e % BK.
    auto load_rows = [&](int kc, int buf) {
        float* dst = xs + buf * BM * LDA;
#pragma unroll
        for (int r = 0; r < BM * BK / THREADS; ++r) {
            const int e = tid + THREADS * r, m = e / BK, k = e % BK;
            const int64_t i = gx0 + (int64_t)m * s + kc * BK + k;
            const bool ok = i >= 0 && i < n;
            cp_async4(dst + m * LDA + k, ok ? xb + i : xb, ok);
        }
    };

    // xs[a_off + j] holds x[gx0 + j]; a_off puts 16-byte global runs on
    // 16-byte shared addresses.
    int a_off = 0;
    if constexpr (SPAN) {
        const uintptr_t p = reinterpret_cast<uintptr_t>(x)
            + (uintptr_t)(4 * ((int64_t)b * n + gx0));
        a_off = (int)((p >> 2) & 3);
        const int64_t base = gx0 - a_off;
        for (int q = tid; q < span / 4; q += THREADS) {
            const int64_t i = base + 4 * q;
            float* dst = xs + 4 * q;
            if (i >= 0 && i + 3 < n) {
                cp_async16(dst, xb + i);
            } else {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const bool ok = i + u >= 0 && i + u < n;
                    cp_async4(dst + u, ok ? xb + i + u : xb, ok);
                }
            }
        }
    } else {
        load_rows(0, 0);
    }
    load_b(0, 0);
    cp_async_commit();

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;

    const int rs = SPAN ? s : LDA;          // shared row stride of A
    const int row = wm * 16 * MT + gq;      // this thread's first frame
    for (int kc = 0; kc < chunks; ++kc) {
        const int buf = kc & 1;
        if (kc + 1 < chunks) {
            if constexpr (!SPAN) load_rows(kc + 1, buf ^ 1);
            load_b(kc + 1, buf ^ 1);
        }
        cp_async_commit();                  // possibly empty: keeps the count
        cp_async_wait_prev();
        __syncthreads();

        const float* ab = SPAN ? xs + a_off + kc * BK : xs + buf * BM * LDA;
        const float* bb = bs + buf * B_TILE + wn * NT * 8 + gq;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
            uint32_t ah[MT][4], al[MT][4];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const float* p = ab + (row + 16 * i) * rs + kk + tq;
                split(p[0], ah[i][0], al[i][0]);            // (g,     t)
                split(p[8 * rs], ah[i][1], al[i][1]);       // (g + 8, t)
                split(p[4], ah[i][2], al[i][2]);            // (g,     t + 4)
                split(p[8 * rs + 4], ah[i][3], al[i][3]);   // (g + 8, t + 4)
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (c0 + wn * NT * 8 + 8 * j >= V) break;   // n-tiles past V
                const float* q = bb + (kk + tq) * LDB + 8 * j;
                uint32_t bh0, bl0, bh1, bl1;
                split(q[0], bh0, bl0);                      // (k = t,     n = g)
                split(q[4 * LDB], bh1, bl1);                // (k = t + 4, n = g)
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    // The step's three products sum in a fresh t, added to
                    // acc in fp32: an mma truncates its sum at the largest
                    // addend's exponent, so a running acc as its C operand
                    // would drop the products' low bits at every step.
                    float t[4] = {0.f, 0.f, 0.f, 0.f};
                    mma(t, al[i], bh0, bh1);
                    mma(t, ah[i], bl0, bl1);
                    mma(t, ah[i], bh0, bh1);
#pragma unroll
                    for (int u = 0; u < 4; ++u) acc[i][j][u] += t[u];
                }
            }
        }
        __syncthreads();                    // buf is refilled at kc + 2
    }

    // The tile through shared memory (free now: the launcher sizes it to
    // hold BM x LDC floats).
    float* cs = smem;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int r = row + 16 * i, c = wn * NT * 8 + 8 * j + 2 * tq;
            cs[r * LDC + c] = acc[i][j][0];
            cs[r * LDC + c + 1] = acc[i][j][1];
            cs[(r + 8) * LDC + c] = acc[i][j][2];
            cs[(r + 8) * LDC + c + 1] = acc[i][j][3];
        }
    __syncthreads();

    const int nf = min(BM, f_out - f0);
    const int d = V - P;
    const int64_t row0 = (int64_t)b * f_out + f0;
    const bool vec = P % 4 == 0 && (reinterpret_cast<uintptr_t>(y0) & 15) == 0;
    for (int e = tid; e < nf * (BN / 4); e += THREADS) {
        const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
        const int col = c0 + c;
        const float* v = cs + r * LDC + c;
        if (vec && col < P) {
            *reinterpret_cast<float4*>(y0 + (row0 + r) * P + col) =
                *reinterpret_cast<const float4*>(v);
            continue;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if (col + u < P)
                y0[(row0 + r) * P + col + u] = v[u];
            else if (col + u < V)
                inj[(row0 + r) * d + col + u - P] = v[u];
        }
    }
}

template <int MT, bool SPAN>
int launch_tf32(const float* x, const float* g, float* y0, float* inj,
                int batch, int n, int f_out, int W, int V, int P, int s,
                int pad_left, cudaStream_t stream)
{
    constexpr int BM = WARPS_M * 16 * MT;
    const int chunks = (W + BK - 1) / BK;
    // a_off (<= 3) + the last frame's window start + every chunk's taps.
    const int64_t span = SPAN ? (3 + (int64_t)(BM - 1) * s + chunks * BK + 3) / 4 * 4 : 0;
    const int64_t operands = 2 * B_TILE + (SPAN ? span : 2 * BM * LDA);
    const size_t smem = sizeof(float) * (operands > BM * LDC ? operands : BM * LDC);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fir_tf32_kernel<MT, SPAN>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int nfb = (f_out + BM - 1) / BM, ncb = (V + BN - 1) / BN;
    const int64_t blocks = (int64_t)nfb * ncb * batch;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    fir_tf32_kernel<MT, SPAN><<<(unsigned)blocks, THREADS, smem, stream>>>(
        x, g, y0, inj, n, f_out, W, V, P, s, pad_left, nfb, ncb, (int)span);
    return (int)cudaGetLastError();
}

// BM from the span's size: 64 frames, else 32, else the streamed windows.
int launch(const float* x, const float* g, float* y0, float* inj, int batch,
           int n, int f_out, int W, int V, int P, int s, int pad_left,
           void* stream)
{
    if (batch <= 0 || f_out <= 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t wpad = (W + BK - 1) / BK * BK;
    auto span_bytes = [&](int bm) { return 4 * (6 + (int64_t)(bm - 1) * s + wpad); };
    if (span_bytes(64) <= SPAN_MAX_BYTES)
        return launch_tf32<2, true>(x, g, y0, inj, batch, n, f_out, W, V, P, s, pad_left, st);
    if (span_bytes(32) <= SPAN_MAX_BYTES)
        return launch_tf32<1, true>(x, g, y0, inj, batch, n, f_out, W, V, P, s, pad_left, st);
    return launch_tf32<2, false>(x, g, y0, inj, batch, n, f_out, W, V, P, s, pad_left, st);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int fir_cat_launch(const float* x, const float* g2, float* y0, float* inj,
                   int batch, int n, int f_pad, int W, int V, int P, int s,
                   int pad_left, void* stream)
{
    return launch(x, g2, y0, inj, batch, n, f_pad, W, V, P, s, pad_left, stream);
}

// The frames FIR: the same body with V = P and no inj output.
int fir_frames_launch(const float* x, const float* g, float* y, int batch,
                      int n, int f_out, int W, int P, int s, int pad_left,
                      void* stream)
{
    return launch(x, g, y, nullptr, batch, n, f_out, W, P, P, s, pad_left, stream);
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
