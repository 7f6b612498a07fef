// K1 (EQ-fused polyphase FIR, "cat" FIR) and the frames FIR (K3-K6, E1)
// for Hopper, fp32 SIMT: one kernel body, two launchers.
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
// polyphase_fir_shear_frames (K5) and experiments/fir.py:polyphase_fir
// (E1): five TPU stagings of one function.  Strided window loads make any
// stride s nothing special here, so the kernel has no s >= 8 limit; the
// wrappers keep the TPU routes' ValueErrors so the contract matches.
//
// What bounds it on an H100, at the serving shape (L/M = 160/147: P = 160,
// s = 147, W = 187, d = 10, batch 8 x 60 s, f_pad = 18432): about 4.7 G
// multiply-adds (4.4 G for the frames FIR) against about 85 MB read and
// 100 MB written (data-sheet planning figures, not measurements).  In fp32
// SIMT the kernel is bound by FMA issue; a tensor-core version would be
// bound by memory.
//
// Design: a register-tiled SGEMM over the implicit window matrix
// A[f, w] = x_pad[f*s + w] (never materialized).  A block owns BM = 128
// frames x BN = 96 columns of one batch row; the taps stream in chunks of
// BK = 16 through double-buffered shared tiles: A tap-major (As[k][m], so a
// thread reads its 8 consecutive frames as two float4) and G2 row-major
// (Bs[k][c]).  Each of the 256 threads accumulates 8 frames x 6 columns in
// fp32 registers: per tap, 5 shared loads feed 48 FMAs.  The next chunk is
// fetched from global memory into registers while the current one is
// multiplied.  Taps past W read G2 as zero, columns past V are not stored.
// Precision: plain fp32 FMAs, at least as accurate as the TPU's bf16x3, so
// the one kernel serves src_fast = True and False.  A bf16x3 / 3xTF32
// tensor-core path is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;             // frames per block
constexpr int BN = 96;              // columns per block
constexpr int BK = 16;              // taps per chunk
constexpr int TM = 8;               // frames per thread
constexpr int TN = 6;               // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 16 x 16 = 256
constexpr int LDA = BM + 4;         // As row stride (16-byte aligned rows)
constexpr int A_PER = BM * BK / THREADS;         // 8 A elements per thread
constexpr int B_PER = BK * BN / THREADS;         // 6 B elements per thread

static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0, "tiling");

__global__ void __launch_bounds__(THREADS, 2)
fir_cat_kernel(const float* __restrict__ x, const float* __restrict__ g2,
               float* __restrict__ y0, float* __restrict__ inj,
               int n, int f_pad, int W, int V, int P, int s, int pad_left)
{
    __shared__ __align__(16) float As[2][BK][LDA];
    __shared__ __align__(16) float Bs[2][BK][BN];

    const int tid = threadIdx.x;
    const int tn = tid % (BN / TN);     // column group: lanes 0..15 of a warp
    const int tm = tid / (BN / TN);     // frame group: 2 per warp
    const int f0 = blockIdx.x * BM;
    const int c0 = blockIdx.y * BN;
    const int b = blockIdx.z;
    const float* xb = x + (int64_t)b * n;
    const int64_t xbase = (int64_t)f0 * s - pad_left;

    float ra[A_PER], rb[B_PER];
    // Chunk k0 of the window matrix and of G2, global -> registers.
    auto fetch = [&](int k0) {
#pragma unroll
        for (int r = 0; r < A_PER; ++r) {
            const int e = tid + r * THREADS;
            const int k = e % BK, m = e / BK;
            const int64_t idx = xbase + (int64_t)m * s + k0 + k;
            ra[r] = (idx >= 0 && idx < n) ? __ldg(xb + idx) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < B_PER; ++r) {
            const int e = tid + r * THREADS;
            const int k = e / BN, c = e % BN;
            const int w = k0 + k, col = c0 + c;
            rb[r] = (w < W && col < V) ? __ldg(g2 + (int64_t)w * V + col) : 0.f;
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int r = 0; r < A_PER; ++r) {
            const int e = tid + r * THREADS;
            As[buf][e % BK][e / BK] = ra[r];
        }
#pragma unroll
        for (int r = 0; r < B_PER; ++r) {
            const int e = tid + r * THREADS;
            Bs[buf][e / BN][e % BN] = rb[r];
        }
    };

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    const int chunks = (W + BK - 1) / BK;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int kc = 0; kc < chunks; ++kc) {
        const int cur = kc & 1;
        if (kc + 1 < chunks) fetch((kc + 1) * BK);
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][tm * TM]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][tm * TM + 4]);
            const float2 b0 = *reinterpret_cast<const float2*>(&Bs[cur][k][tn * TN]);
            const float2 b1 = *reinterpret_cast<const float2*>(&Bs[cur][k][tn * TN + 2]);
            const float2 b2 = *reinterpret_cast<const float2*>(&Bs[cur][k][tn * TN + 4]);
            const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float g[TN] = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
        }
        if (kc + 1 < chunks) stash(cur ^ 1);
        __syncthreads();
    }

    const int d = V - P;
    const int64_t row0 = (int64_t)b * f_pad;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int f = f0 + tm * TM + i;
        if (f >= f_pad) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = c0 + tn * TN + j;
            if (c < P) {
                y0[(row0 + f) * P + c] = acc[i][j];
            } else if (c < V) {
                inj[(row0 + f) * d + (c - P)] = acc[i][j];
            }
        }
    }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int fir_cat_launch(const float* x, const float* g2, float* y0, float* inj,
                   int batch, int n, int f_pad, int W, int V, int P, int s,
                   int pad_left, void* stream)
{
    const dim3 grid((f_pad + BM - 1) / BM, (V + BN - 1) / BN, batch);
    fir_cat_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, g2, y0, inj, n, f_pad, W, V, P, s, pad_left);
    return (int)cudaGetLastError();
}

// The frames FIR: the same body with V = P and no inj output.
int fir_frames_launch(const float* x, const float* g, float* y, int batch,
                      int n, int f_out, int W, int P, int s, int pad_left,
                      void* stream)
{
    const dim3 grid((f_out + BM - 1) / BM, (P + BN - 1) / BN, batch);
    fir_cat_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, g, y, nullptr, n, f_out, W, P, P, s, pad_left);
    return (int)cudaGetLastError();
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
