// E6: the butterfly rfft of real rows for Hopper, on the register-radix
// FFT of csrc/fft_radix.cuh (fp32 SIMT).
//
// Replaces the TPU kernel dsp_audio_project_tpu/kernels/experiments/
// rfft_butterfly.py: rfft_pallas (body _fft_stages_kernel): for a real row
// x of N = 2*nh points, pack z[m] = x[2m] + i x[2m+1], run an nh-point
// complex FFT and untwiddle the packed real input, X[k] = (Z[k] + conj
// Z[nh-k]) / 2 + e^{-2 pi i k / N} (Z[k] - conj Z[nh-k]) / (2i), k = 0..nh.
// The TPU kernel runs the FFT as log2(nh) radix-2 stages on its lanes; this
// kernel computes the same function by the header's plan: ceil(log2(nh)/4)
// Stockham passes of radix <= 16 held in registers, one exchange through
// swizzled shared memory between passes, the untwiddle fused into the store
// (the kernel of K2 and of K7 up to N = 32768, under E6's own launcher and
// launch count).  Above N = 32768 the wrapper runs K7's two passes.
//
// What bounds it on an H100, at the STFT's frames (41344 rows of 2048): it
// reads 339 MB and writes 339 MB of complex64, 0.2023 ms at 3.35 TB/s; its
// 2.5 N log2 N flops a row (2.3 GFLOP) take 0.034 ms at the fp32 rate.  So
// each row is read once into registers and X written once, with no pass over
// the row in shared memory beyond the exchanges.
//
// Values a thread E: the radix-2 design's N = 4..128 need their own
// instantiations (E must be a multiple of every pass's radix and at most
// nh): E = nh up to nh = 16 (one thread a row, 256 rows a block), then 16;
// N = 256..8192 use K2's E = 16, N = 16384 and 32768 K7's E = 32.

#include "fft_radix.cuh"

namespace {

using fft_radix::launch_rows;

int launch(const float* x, void* out, const float* tw, const float* un,
           int64_t rows, int L, cudaStream_t s)
{
    switch (L) {
    case 1: return launch_rows<1, 2, false>(x, out, tw, un, rows, s);
    case 2: return launch_rows<2, 4, false>(x, out, tw, un, rows, s);
    case 3: return launch_rows<3, 8, false>(x, out, tw, un, rows, s);
    case 4: return launch_rows<4, 16, false>(x, out, tw, un, rows, s);
    case 5: return launch_rows<5, 16, false>(x, out, tw, un, rows, s);
    case 6: return launch_rows<6, 16, false>(x, out, tw, un, rows, s);
    case 7: return launch_rows<7, 16, false>(x, out, tw, un, rows, s);
    case 8: return launch_rows<8, 16, false>(x, out, tw, un, rows, s);
    case 9: return launch_rows<9, 16, false>(x, out, tw, un, rows, s);
    case 10: return launch_rows<10, 16, false>(x, out, tw, un, rows, s);
    case 11: return launch_rows<11, 16, false>(x, out, tw, un, rows, s);
    case 12: return launch_rows<12, 16, false>(x, out, tw, un, rows, s);
    case 13: return launch_rows<13, 32, false>(x, out, tw, un, rows, s);
    case 14: return launch_rows<14, 32, false>(x, out, tw, un, rows, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// out (rows, N/2+1) complex64 as interleaved floats, from x (rows, N)
// float32 (8-byte aligned rows), N = 2^(L+1) with 1 <= L <= 14.  tw: nh
// complex64 W_nh^m; un: nh/2 + 1 complex64 e^{-2 pi i k / N}
// (kernels/fft_radix.radix_tables).  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int rfft_butterfly_launch(const float* x, float* out, const float* tw,
                          const float* un, int rows, int L, void* stream)
{
    return launch(x, out, tw, un, rows, L, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
