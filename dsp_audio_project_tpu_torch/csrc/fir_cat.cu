// K1 (EQ-fused polyphase FIR, "cat" FIR) and the frames FIR (K3-K6, E1,
// E3-E5) for Hopper's tensor cores: one kernel, two launchers.
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
// fir_frames_launch runs the same kernel with V = P (G instead of G2, no inj
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
// Arithmetic (both bodies): each operand splits into hi = rna_tf32(v) and
// lo = rna_tf32(v - hi), the rounding of cvt.rna.tf32.f32 done as two
// integer ops on the bits (the compiler cannot fold v - hi to 0 through
// them; the build has no --use_fast_math).  Each 8-tap step's products
// a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first, go into a fresh
// accumulator, which is added to the running one in fp32 after a run of
// steps: the tensor core truncates its sum at the exponent of its largest
// addend, so with the running sum as its C operand it would drop the
// products' low bits at every step, which costs most where the outputs
// cancel (the inj columns of K1).  The run is one step in the mma.sync
// body and FRESH = 2 steps (16 taps) in the warpgroup body, which halves
// its fp32 adds; on the card that reads 134.7 dB (inj 133.6) against the
// fp32 plain version at the serving shape, against 136.4 (135.9) at one
// step and 132.1 (130.4) at four (scripts/fir_variants.py).  3xTF32 so
// summed keeps the fp32 result (kernels/fir_class.py mirrors it, in this
// order, as tf32_split / fir_frames_3xtf32) and serves src_fast = True and
// False.
//
// The warpgroup body (fir_tf32_kernel<N>), for every shape whose 128-frame
// span of x fits in shared memory (all of the main path's): Hopper's wgmma,
// one block of three warpgroups on each SM walking tiles of 128 frames x N
// columns, N = V rounded up to 64, 128, 160 or 176 (176 at V = 170 and
// 172, 160 for the frames FIR at 160/147; V > 176 is cut into ceil(V / 176)
// column blocks).  So x's span is copied and split once a tile; the mma.sync
// body did both once per 96-column block (twice at V = 170).
// * B: tf32 wgmma reads B from shared memory, K-major: 8 x 4-float core
//   matrices, the two of a k-step 128 bytes apart, the next 8 columns 256
//   bytes on.  G2's TF32 halves whole (~263 KB at 160/147) do not fit, and
//   splitting them in the kernel cost more than the products (a draft did
//   it on one producer warpgroup: 4-byte cp.async of G2's rows of V floats,
//   which are not 16-byte aligned, then the split; it ran slower than the
//   mma.sync body).  So each launch first runs tf32_halves_kernel, which
//   writes the halves in that layout into scratch the wrapper allocates
//   (270 KB at 160/147, ~1.7 us), and one producer lane streams them into a
//   ring of SLOTS = 3 slots of SUB = 2 k-steps, one cp.async.bulk on an
//   mbarrier a slot.  G2 itself stays what every caller passes.  Both
//   consumers read each slot.
// * A, the window matrix A[f, w] = x_pad[f*s + w], has a row stride of s
//   floats (588 bytes at s = 147), which no shared-memory descriptor can
//   express, so A comes from registers.  Three producer warps copy each
//   tile's one contiguous span, x_pad[f0*s] .. x_pad[(f0 + 127)*s + 8*k),
//   into shared memory: its 16-byte-aligned interior as one cp.async.bulk,
//   the ragged ends and the zero padding outside [0, n) by thread stores
//   (rows of n floats are not 16-byte aligned when n % 4 != 0, so no tensor
//   map describes them).  Two span buffers where they fit, so the next
//   tile's span lands during this one.  Each consumer thread reads its four
//   A elements a k-step, xs[(f - f0)*s + w], and splits them once.
// * Consumers: two warpgroups, 64 frames each, one m64nNk8 wgmma a product,
//   then wait, release the slots, and add the run into the running sum:
//   2 x N/2 fp32 registers a thread (176 at N = 176), hence setmaxnreg 232
//   for the consumers and 40 for the producer warpgroup.  They take turns
//   to issue a run's products (named barriers 1 and 2), so that one adds,
//   splits and loads while the other's products run; issued at once, both
//   ran their products together and then their adds together, and the
//   tensor cores idled through the adds (142 against 128 us).
// * Epilogue: straight from the accumulators; lane pairs swap halves with
//   one shuffle so that each thread stores 4 consecutive y0 columns as one
//   16-byte store where P % 4 == 0 (8 frames x 32 bytes a warp store: whole
//   sectors), inj and ragged columns one float at a time.
// What bounds it now (scripts/fir_variants.py at the serving shape): the
// consumers' issue slots more than the tensor cores.  With the products
// removed it still takes ~100 of its ~128 us (A fragments and their split,
// the run adds, the ring's waits, the copies); the stores add ~23 us at the
// tile ends, when both consumers store while the tensor cores idle.
//
// The mma.sync body (fir_tf32_kernel<MT, SPAN>), for shapes whose 128-frame
// span does not fit (s above ~320 at W ~ 1.3 s): warp-level mma.sync
// m16n8k8 TF32; a block owns BM = 32 MT consecutive frames and 96 columns
// (warps 2 x 2, each 16 MT frames x 48 columns); its span of x in shared
// memory with cp.async at BM = 32 where that fits 96 KB (s up to ~750),
// else the windows streamed at BM = 64, 16 taps a chunk (any s, W); B in
// 16-tap chunks through two cp.async buffers.  The choice is by shape only
// (fir_tf32_route); a launch that fails raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---- the warpgroup body ----------------------------------------------------

namespace wg {
constexpr int TM = 128;             // frames a tile: two consumers of 64
constexpr int KS = 8;               // taps a chunk: one wgmma k-step
constexpr int SUB = 2;              // k-steps a ring slot holds
constexpr int SLOTS = 3;            // slots in the ring
constexpr int FRESH = 2;            // k-steps a fresh accumulator takes
static_assert(FRESH % SUB == 0 && FRESH / SUB <= SLOTS, "fresh runs span whole slots");
constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int SPAN_THREADS = 96;    // producer warps 1-3
constexpr int NMAX = 176;           // widest column block: 2 x 88 registers
// No-swizzle K-major core matrices (8 rows x 16 bytes): the two of a k-step
// 128 bytes apart (LBO), the next 8 columns 256 bytes on (SBO).
constexpr uint32_t LBO = 128, SBO = 256;

__host__ __device__ constexpr int plane_floats(int n) { return n * KS; }
__host__ __device__ constexpr int kstep_floats(int n) { return 2 * plane_floats(n); }
__host__ __device__ constexpr int slot_floats(int n) { return SUB * kstep_floats(n); }
}  // namespace wg

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar's transaction count.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Named barrier `id` over the two consumer warpgroups (256 threads): wait
// for it, or arrive without waiting.
__device__ __forceinline__ void named_sync(int id)
{
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id)
{
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4)
        | ((uint64_t)(wg::LBO >> 4) << 16) | ((uint64_t)(wg::SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all()
{
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes of v across the
// asynchronous products (placed after their wait).
__device__ __forceinline__ void reg_fence(float& v)
{
    asm volatile("" : "+f"(v) :: "memory");
}

__device__ __forceinline__ void reg_fence(uint32_t& v)
{
    asm volatile("" : "+r"(v) :: "memory");
}

// d (+)= a b on a 64 x N x 8 tile: a the 4 TF32 registers of this thread's
// A fragment (rows g and g + 8 of its warp's 16, taps t and t + 4), b the
// descriptor of the K-major B chunk; scale_d = 0 ignores d's old value.
template <int N> struct Wgmma;

#define F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
template <> struct Wgmma<64> {
    static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d)
    {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
        "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
        "}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24)
        : WGMMA_IN);
    }
};
template <> struct Wgmma<128> {
    static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d)
    {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
        "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,"
        "%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
        "}, {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
        : WGMMA_IN);
    }
};
template <> struct Wgmma<160> {
    static __device__ __forceinline__ void mma(float (&d)[80], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d)
    {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
        "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,"
        "%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,"
        "%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79"
        "}, {%80,%81,%82,%83}, %84, p, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72)
        : WGMMA_IN);
    }
};
template <> struct Wgmma<176> {
    static __device__ __forceinline__ void mma(float (&d)[88], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d)
    {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k8.f32.tf32.tf32 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
        "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,"
        "%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,"
        "%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87"
        "}, {%88,%89,%90,%91}, %92, p, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72), F8(80)
        : WGMMA_IN);
    }
};
#undef F8
#undef WGMMA_IN

struct WgArgs {
    const float* x;                 // (batch, n)
    const float* planes;            // [ncb][chunks][hi | lo]: G's TF32 halves
    float* y0;                      // (batch, f_out, P)
    float* inj;                     // (batch, f_out, V - P)
    int n, f_out, V, P, s, pad_left;
    int nft, ncb, tiles, ksteps;    // frame tiles a row, column blocks, all tiles, k-steps (a multiple of FRESH)
    int span, nspan;                // floats a span buffer (a multiple of 4), buffers
};

// x_pad index gx0 sits at xs[a_off]: a_off puts 16-byte global runs on
// 16-byte shared addresses.
__device__ __forceinline__ int span_offset(const float* xb, int64_t gx0)
{
    return (int)(((reinterpret_cast<uintptr_t>(xb) + (uintptr_t)(4 * gx0)) >> 2) & 3);
}

// A fragment of one k-step from the span: (row, t), (row + 8, t),
// (row, t + 4), (row + 8, t + 4), q at (row, t).
__device__ __forceinline__ void load_fragment(float (&v)[4], const float* q,
                                              int s8)
{
    v[0] = q[0];
    v[1] = q[s8];
    v[2] = q[4];
    v[3] = q[s8 + 4];
}

__device__ __forceinline__ void tile_coords(const WgArgs& p, int tile, int& b,
                                            int& f0, int& cb)
{
    cb = tile % p.ncb;
    const int rest = tile / p.ncb;
    f0 = (rest % p.nft) * wg::TM;
    b = rest / p.nft;
}

// G (W, V) -> its TF32 halves as the B chunks of the warpgroup body, one
// float4 of 4 taps a thread: planes[cb][ks][h][...] with column c of block
// cb at core matrix (c / 8, taps 4 (q & 1) .. + 3), row c % 8; taps past W
// and columns past V are zero.
template <int N>
__global__ void __launch_bounds__(256)
tf32_halves_kernel(const float* __restrict__ g, float* __restrict__ planes,
                   int W, int V, int ncb, int ksteps)
{
    const int e = blockIdx.x * 256 + threadIdx.x;
    if (e >= ncb * ksteps * 2 * N) return;
    const int c = e % N, q = e / N;             // q: (cb, ks, tap half)
    const int h = q & 1, ks = (q >> 1) % ksteps, cb = (q >> 1) / ksteps;
    const int col = cb * N + c, w0 = ks * wg::KS + 4 * h;
    uint4 vh, vl;
    uint32_t* ph = &vh.x;
    uint32_t* pl = &vl.x;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        split(w0 + i < W && col < V ? g[(int64_t)(w0 + i) * V + col] : 0.f,
              ph[i], pl[i]);
    float* hi = planes + (int64_t)(cb * ksteps + ks) * wg::kstep_floats(N);
    const int off = (c >> 3) * 64 + h * 32 + (c & 7) * 4;
    *reinterpret_cast<uint4*>(hi + off) = vh;
    *reinterpret_cast<uint4*>(hi + wg::plane_floats(N) + off) = vl;
}

template <int N>
__global__ void __launch_bounds__(wg::THREADS, 1)
fir_tf32_kernel(const WgArgs p)
{
    using namespace wg;
    constexpr int M = N / 2;                    // accumulator floats a thread
    constexpr uint32_t SLOT_BYTES = 4 * slot_floats(N);
    // Descriptor steps (16-byte units): one k-step's halves, hi to lo.
    constexpr uint64_t KSTEP_DESC = kstep_floats(N) / 4, LO_DESC = KSTEP_DESC / 2;
    extern __shared__ __align__(128) unsigned char wg_smem[];
    float* ring = reinterpret_cast<float*>(wg_smem);    // [SLOTS][SUB][hi | lo]
    float* xs = ring + SLOTS * slot_floats(N);          // [nspan][span]
    uint64_t* full = reinterpret_cast<uint64_t*>(xs + p.nspan * p.span);
    uint64_t* empty = full + SLOTS;
    uint64_t* span_full = empty + SLOTS;
    uint64_t* span_empty = span_full + 2;

    if (threadIdx.x == 0) {
        for (int i = 0; i < SLOTS; ++i) {
            mbar_init(full + i, 1);
            mbar_init(empty + i, CONSUMER_WARPS);
        }
        for (int i = 0; i < 2; ++i) {
            mbar_init(span_full + i, SPAN_THREADS);
            mbar_init(span_empty + i, CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int my_tiles = (int)blockIdx.x < p.tiles
        ? (p.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;

    if (threadIdx.x < 128) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x < 32) {
            // ---- warp 0, one lane: G's halves, SUB k-steps a bulk copy ----
            if (threadIdx.x != 0) return;
            const int per_tile = p.ksteps / SUB, total = my_tiles * per_tile;
            int slot = 0;
            uint32_t phase = 0;
            for (int q = 0; q < total; ++q) {
                const int it = q / per_tile, k = q - it * per_tile;
                int b, f0, cb;
                tile_coords(p, (int)blockIdx.x + it * (int)gridDim.x, b, f0, cb);
                mbar_wait(empty + slot, phase ^ 1);
                mbar_arrive_expect_tx(full + slot, SLOT_BYTES);
                bulk_copy(ring + slot * slot_floats(N),
                          p.planes + (int64_t)(cb * p.ksteps + k * SUB) * kstep_floats(N),
                          SLOT_BYTES, full + slot);
                if (++slot == SLOTS) { slot = 0; phase ^= 1; }
            }
            // Leave once the consumers have released every slot.
            for (int i = 0; i < SLOTS; ++i) {
                mbar_wait(empty + slot, phase ^ 1);
                if (++slot == SLOTS) { slot = 0; phase ^= 1; }
            }
            return;
        }
        // ---- warps 1-3: each tile's span of x, once its buffer is free ----
        const int tid = threadIdx.x - 32;
        for (int it = 0; it < my_tiles; ++it) {
            int b, f0, cb;
            tile_coords(p, (int)blockIdx.x + it * (int)gridDim.x, b, f0, cb);
            const int sb = it % p.nspan;
            mbar_wait(span_empty + sb, ((it / p.nspan) & 1) ^ 1);
            const float* xb = p.x + (int64_t)b * p.n;
            const int64_t gx0 = (int64_t)f0 * p.s - p.pad_left;
            const int64_t p0 = gx0 - span_offset(xb, gx0);  // x index of xs[0]
            float* dst = xs + sb * p.span;
            // [j_lo, j_hi): the span's indices inside [0, n); the bulk copy
            // takes its 16-byte-aligned interior [c_lo, c_hi), the threads
            // the rest.
            const int64_t lo_in = -p0 > 0 ? -p0 : 0, hi_in = p.n - p0;
            const int j_lo = (int)(lo_in < p.span ? lo_in : p.span);
            const int j_hi = (int)(hi_in < j_lo ? j_lo : hi_in < p.span ? hi_in : p.span);
            int c_lo = (j_lo + 3) & ~3, c_hi = j_hi & ~3;
            if (c_hi <= c_lo) c_lo = c_hi = p.span;
            if (tid == 0 && c_hi > c_lo) {
                mbar_expect_tx(span_full + sb, 4u * (c_hi - c_lo));
                bulk_copy(dst + c_lo, xb + p0 + c_lo, 4u * (c_hi - c_lo),
                          span_full + sb);
            }
            for (int j = tid; j < c_lo; j += SPAN_THREADS)
                dst[j] = j >= j_lo && j < j_hi ? xb[p0 + j] : 0.f;
            for (int j = c_hi + tid; j < p.span; j += SPAN_THREADS)
                dst[j] = j >= j_lo && j < j_hi ? xb[p0 + j] : 0.f;
            mbar_arrive(span_full + sb);
        }
        return;
    }

    // ---- consumers: two warpgroups, 64 frames each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int cw = (threadIdx.x >> 7) - 1;                  // 0 or 1
    const int row = 64 * cw + 16 * ((threadIdx.x >> 5) & 3) + g;  // and row + 8
    const uint64_t desc0 = wgmma_desc(smem_addr(ring));
    const int d = p.V - p.P;
    const bool vec = (p.P & 3) == 0 && (reinterpret_cast<uintptr_t>(p.y0) & 15) == 0;
    int slot = 0;
    uint32_t phase = 0;
    float acc[M], fresh[M];
#pragma unroll
    for (int i = 0; i < M; ++i) fresh[i] = 0.f;
    // Turns (named barriers 1 and 2, one per consumer): the first is the
    // first consumer's; the second consumer's last hand-over is taken after
    // the loop, so each barrier completes as often as it is entered.
    if (cw == 1) named_arrive(1);

    for (int it = 0; it < my_tiles; ++it) {
        int b, f0, cb;
        tile_coords(p, (int)blockIdx.x + it * (int)gridDim.x, b, f0, cb);
        const float* xb = p.x + (int64_t)b * p.n;
        const int64_t gx0 = (int64_t)f0 * p.s - p.pad_left;
        const int sb = it % p.nspan;
        const float* xa = xs + sb * p.span + span_offset(xb, gx0) + row * p.s + t;
        const int s8 = 8 * p.s;
#pragma unroll
        for (int i = 0; i < M; ++i) acc[i] = 0.f;
        mbar_wait(span_full + sb, (it / p.nspan) & 1);
        // (The span's padding covers the fragments read past the last
        // k-step.)
        float xv[FRESH][4];
#pragma unroll
        for (int u = 0; u < FRESH; ++u) load_fragment(xv[u], xa + 8 * u, s8);
        for (int ks0 = 0; ks0 < p.ksteps; ks0 += FRESH) {
            // FRESH k-steps' products into `fresh`, then one fp32 add.  The
            // consumers take turns to issue them, so that one adds while
            // the other's products run.
            uint32_t ah[FRESH][4], al[FRESH][4];
#pragma unroll
            for (int u = 0; u < FRESH; ++u)
#pragma unroll
                for (int i = 0; i < 4; ++i) split(xv[u][i], ah[u][i], al[u][i]);
            named_sync(1 + cw);
            wgmma_fence();
#pragma unroll
            for (int u = 0; u < FRESH; ++u) {
                const int sl = (slot + u / SUB) % SLOTS;
                if (u % SUB == 0)
                    mbar_wait(full + sl, phase ^ (slot + u / SUB >= SLOTS));
                const uint64_t bh = desc0 + (uint64_t)(sl * SUB + u % SUB) * KSTEP_DESC;
                const uint64_t bl = bh + LO_DESC;
                Wgmma<N>::mma(fresh, al[u], bh, u);
                Wgmma<N>::mma(fresh, ah[u], bl, 1);
                Wgmma<N>::mma(fresh, ah[u], bh, 1);
            }
            wgmma_commit();
            named_arrive(2 - cw);
#pragma unroll
            for (int u = 0; u < FRESH; ++u)     // the next fragments, meanwhile
                load_fragment(xv[u], xa + 8 * (ks0 + FRESH + u), s8);
            wgmma_wait_all();
#pragma unroll
            for (int u = 0; u < FRESH; ++u)
#pragma unroll
                for (int i = 0; i < 4; ++i) { reg_fence(ah[u][i]); reg_fence(al[u][i]); }
#pragma unroll
            for (int i = 0; i < M; ++i) reg_fence(fresh[i]);
#pragma unroll
            for (int u = 0; u < FRESH / SUB; ++u) {
                if (lane == 0) mbar_arrive(empty + slot);
                if (++slot == SLOTS) { slot = 0; phase ^= 1; }
            }
#pragma unroll
            for (int i = 0; i < M; ++i) acc[i] += fresh[i];
        }
        if (lane == 0) mbar_arrive(span_empty + sb);

        // Epilogue.  acc[4j + u]: row + 8 (u >> 1), column 8 j + 2 t + (u & 1).
        // In a lane pair (t even, t + 1) the even lane takes row's four
        // columns 8 j + 2 t .. + 3, the odd one row + 8's.
        const int64_t base = (int64_t)b * p.f_out + f0;
        const int c0 = cb * N;
        const bool odd = t & 1;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            const float* a = acc + 4 * j;
            const int col = c0 + 8 * j + 2 * t;
            if (vec) {
                const float s0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
                const float s1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
                const int r = odd ? row + 8 : row, c = odd ? col - 2 : col;
                const float o[4] = {odd ? s0 : a[0], odd ? s1 : a[1],
                                    odd ? a[2] : s0, odd ? a[3] : s1};
                if (f0 + r < p.f_out) {
                    const int64_t at = (base + r) * p.P;
                    if (c + 3 < p.P) {
                        *reinterpret_cast<float4*>(p.y0 + at + c) =
                            make_float4(o[0], o[1], o[2], o[3]);
                    } else {
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            if (c + u < p.P) p.y0[at + c + u] = o[u];
                            else if (c + u < p.V)
                                p.inj[(base + r) * d + c + u - p.P] = o[u];
                        }
                    }
                }
            } else {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int r = row + 8 * (u >> 1), c = col + (u & 1);
                    if (f0 + r >= p.f_out || c >= p.V) continue;
                    if (c < p.P) p.y0[(base + r) * p.P + c] = a[u];
                    else p.inj[(base + r) * d + c - p.P] = a[u];
                }
            }
        }
    }
    if (cw == 0) named_sync(1);
}

// The warpgroup body's geometry for a shape: ceil(V / NMAX) column blocks
// of N columns, the span, and two span buffers where they fit, else one.
struct WgShape {
    int N, ncb, ksteps, span, nspan;
    size_t smem;
};

bool wg_shape(int W, int V, int s, WgShape& out)
{
    using namespace wg;
    int optin = 0, dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return false;
    const int ncb = (V + NMAX - 1) / NMAX, per = (V + ncb - 1) / ncb;
    const int N = per <= 64 ? 64 : per <= 128 ? 128 : per <= 160 ? 160 : 176;
    const int ksteps = ((W + KS - 1) / KS + FRESH - 1) / FRESH * FRESH;
    // a_off (<= 3) + the last frame's window start + every k-step's taps,
    // then the fragments read past the last k-step.
    const int64_t span = (3 + (int64_t)(TM - 1) * s + (int64_t)KS * ksteps + 3) / 4 * 4
        + KS * FRESH;
    const int64_t fixed = 4 * (int64_t)SLOTS * slot_floats(N) + 8 * (2 * SLOTS + 4);
    for (int nspan = 2; nspan >= 1; --nspan) {
        const int64_t smem = fixed + 4 * nspan * span;
        if (smem <= optin) {
            out = {N, ncb, ksteps, (int)span, nspan, (size_t)smem};
            return true;
        }
    }
    return false;
}

// Floats of the halves scratch for the warpgroup body.
int64_t wg_scratch(const WgShape& sh)
{
    return (int64_t)sh.ncb * sh.ksteps * wg::kstep_floats(sh.N);
}

template <int N>
int launch_wg(const WgShape& sh, const float* x, const float* g, float* y0,
              float* inj, float* planes, int batch, int n, int f_out, int W,
              int V, int P, int s, int pad_left, cudaStream_t stream)
{
    void (*kernel)(const WgArgs) = fir_tf32_kernel<N>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int nft = (f_out + wg::TM - 1) / wg::TM;
    const int64_t tiles = (int64_t)batch * nft * sh.ncb;
    if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const int items = 2 * N * sh.ncb * sh.ksteps;
    tf32_halves_kernel<N><<<(items + 255) / 256, 256, 0, stream>>>(
        g, planes, W, V, sh.ncb, sh.ksteps);
    const WgArgs a = {x, planes, y0, inj, n, f_out, V, P, s, pad_left, nft,
                      sh.ncb, (int)tiles, sh.ksteps, sh.span, sh.nspan};
    const int grid = (int)(tiles < sms ? tiles : sms);
    kernel<<<grid, wg::THREADS, sh.smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// ---- the mma.sync body: strides whose 128-frame span does not fit -------

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
// else BM x BK windows per chunk, double-buffered like B.  Its blocks own BM
// frames x 96 columns; B streams in 16-tap chunks through two cp.async
// buffers (row stride 104 floats, 8 mod 32: B fragments on distinct banks).
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

// Which body a shape takes: 0 the warpgroup body with two span buffers, 1
// with one, 2 the mma.sync body with its span at BM = 32 frames, 3 its
// streamed windows.  (The spans the mma.sync body could hold at BM = 64
// now fit the warpgroup body.)
int route(int W, int V, int s, WgShape* sh)
{
    WgShape w;
    if (wg_shape(W, V, s, w)) {
        if (sh) *sh = w;
        return w.nspan == 2 ? 0 : 1;
    }
    const int64_t wpad = (W + BK - 1) / BK * BK;
    return 4 * (6 + 31 * (int64_t)s + wpad) <= SPAN_MAX_BYTES ? 2 : 3;
}

int launch(const float* x, const float* g, float* y0, float* inj,
           float* planes, int64_t planes_floats, int batch, int n, int f_out,
           int W, int V, int P, int s, int pad_left, void* stream)
{
    if (batch <= 0 || f_out <= 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    WgShape sh;
    switch (route(W, V, s, &sh)) {
    case 0:
    case 1:
        if (planes == nullptr || planes_floats < wg_scratch(sh))
            return (int)cudaErrorInvalidValue;
        switch (sh.N) {
        case 64:
            return launch_wg<64>(sh, x, g, y0, inj, planes, batch, n, f_out, W, V, P, s, pad_left, st);
        case 128:
            return launch_wg<128>(sh, x, g, y0, inj, planes, batch, n, f_out, W, V, P, s, pad_left, st);
        case 160:
            return launch_wg<160>(sh, x, g, y0, inj, planes, batch, n, f_out, W, V, P, s, pad_left, st);
        default:
            return launch_wg<176>(sh, x, g, y0, inj, planes, batch, n, f_out, W, V, P, s, pad_left, st);
        }
    case 2:
        return launch_tf32<1, true>(x, g, y0, inj, batch, n, f_out, W, V, P, s, pad_left, st);
    default:
        return launch_tf32<2, false>(x, g, y0, inj, batch, n, f_out, W, V, P, s, pad_left, st);
    }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `planes`
// is scratch of fir_tf32_scratch_floats(W, V, s) floats for G2's TF32
// halves (null where that is 0).
int fir_cat_launch(const float* x, const float* g2, float* y0, float* inj,
                   float* planes, int64_t planes_floats, int batch, int n,
                   int f_pad, int W, int V, int P, int s, int pad_left,
                   void* stream)
{
    return launch(x, g2, y0, inj, planes, planes_floats, batch, n, f_pad, W,
                  V, P, s, pad_left, stream);
}

// The frames FIR: the same kernel with V = P and no inj output.
int fir_frames_launch(const float* x, const float* g, float* y, float* planes,
                      int64_t planes_floats, int batch, int n, int f_out,
                      int W, int P, int s, int pad_left, void* stream)
{
    return launch(x, g, y, nullptr, planes, planes_floats, batch, n, f_out, W,
                  P, P, s, pad_left, stream);
}

// The body a (W, V, s) takes on the current card (see route); info gets
// the warpgroup body's N, column blocks, span buffers and shared bytes
// (zeros for the mma.sync body).
int fir_tf32_route(int W, int V, int s, int* info)
{
    WgShape sh = {0, 0, 0, 0, 0, 0};
    const int r = route(W, V, s, &sh);
    info[0] = sh.N;
    info[1] = sh.ncb;
    info[2] = sh.nspan;
    info[3] = (int)sh.smem;
    return r;
}

// Floats of scratch a launch at (W, V, s) needs for G's TF32 halves.
int fir_tf32_scratch_floats(int W, int V, int s)
{
    WgShape sh;
    return route(W, V, s, &sh) <= 1 ? (int)wg_scratch(sh) : 0;
}

const char* kernel_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
