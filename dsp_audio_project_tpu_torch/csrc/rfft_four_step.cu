// K2: batched rfft of real rows, N = 256..8192, as a register-radix FFT for
// Hopper (fp32 SIMT).
//
// Replaces the TPU kernel dsp_audio_project_tpu/kernels/rfft.py:
// rfft_pallas_four_step (body _four_step_kernel), both forms: |X| (the
// spectrum op, launcher rfft_mag_launch) and complex X as interleaved
// (re, im) floats, the layout of complex64 (the STFT, rfft_complex_launch).
// The TPU kernel's four-step split n1 x n2 is a shape for its matrix unit;
// this kernel computes the same function by its own plan.
//
// What bounds it on an H100: bytes.  At the STFT's frames (41344 rows of
// 2048) it reads 339 MB and writes 339 MB (0.2023 ms at 3.35 TB/s); its
// ~2.5 N log2 N flops a row take a sixth of that at the fp32 rate, so the
// design keeps the arithmetic lean and the traffic at one read of x and
// one write of X.  The serving chain's 24 rows are bound by latency: a few
// microseconds of passes per block.
//
// Design (csrc/fft_radix.cuh): the row is packed as nh = N/2 complex
// points, z[m] = x[2m] + i x[2m+1], and read straight from global memory
// into registers (each warp load is 32 consecutive 8-byte pairs).  The
// nh-point FFT runs as ceil(log2(nh)/4) Stockham passes of radix <= 16 in
// registers, 16 values a thread (256 = 16 * 8, 1024 = 16 * 8 * 8, 4096 =
// 16 * 16 * 16), with one exchange through swizzled shared memory between
// passes; the twiddles come from an fp32 table of W_nh^m built in float64
// (8 KB at N = 2048, read through L1).  The packed-real untwiddle and |X|
// are fused into the store: a thread forms X[k] and X[nh-k] from Z[k] and
// Z[nh-k], so both stores are coalesced runs.  A 256-thread block holds
// max(1, 4096/nh) rows (4 at N = 2048, 33 KB of shared memory),
// so several blocks share an SM and one block's loads overlap another's
// passes; there is no persistent grid and no cp.async prefetch, because
// the resident blocks already keep the loads in flight.

#include "fft_radix.cuh"

namespace {

using fft_radix::launch_rows;

template <bool MAG>
int launch(const float* x, const float* tw, const float* un, void* out,
           int rows, int n, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n) {
    case 256: return launch_rows<7, 16, MAG>(x, out, tw, un, rows, s);
    case 512: return launch_rows<8, 16, MAG>(x, out, tw, un, rows, s);
    case 1024: return launch_rows<9, 16, MAG>(x, out, tw, un, rows, s);
    case 2048: return launch_rows<10, 16, MAG>(x, out, tw, un, rows, s);
    case 4096: return launch_rows<11, 16, MAG>(x, out, tw, un, rows, s);
    case 8192: return launch_rows<12, 16, MAG>(x, out, tw, un, rows, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// |rfft| of `rows` rows of length n (a power of two in 256..8192; x 8-byte
// aligned) into out (rows, n/2+1) float32.  tw: n/2 complex64 W_{n/2}^m;
// un: n/4 + 1 complex64 e^{-2 pi i k / n}.  Returns cudaGetLastError()
// (0 on success).
int rfft_mag_launch(const float* x, const float* tw, const float* un,
                    float* out, int rows, int n, void* stream)
{
    return launch<true>(x, tw, un, out, rows, n, stream);
}

// rfft of `rows` rows of length n into out (rows, n/2+1) complex64, as
// interleaved (re, im) floats; the contract of rfft_mag_launch.
int rfft_complex_launch(const float* x, const float* tw, const float* un,
                        float* out, int rows, int n, void* stream)
{
    return launch<false>(x, tw, un, out, rows, n, stream);
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
