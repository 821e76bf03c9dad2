// The viewer's image on the card: the lane-ordered uint8 pixels un-swizzled
// into an [H*s, W*s, 3] image, each pixel repeated into its s x s block,
// one thread a lane.
//
// Replaces: no TPU kernel. The JAX package un-swizzles on the host
// (tpu_pathtracer/tracer/renderer.py: accum_to_image) and the viewer
// repeats the pixels with np.repeat (tools/interactive.py). The port did
// the same in numpy, after a copy of the lane-ordered uint8 to the host:
// a fancy-index scatter of every pixel and two np.repeat passes, host
// work during which the card waits. This kernel does both in one launch
// on the card, so the host copies the finished image once:
//   in:  rgb [n,3] uint8, the tonemapped lanes (tracer/renderer.py:
//        Renderer.accum_to_image); lane_px, lane_py [n] int32, the pixel
//        of each lane (tracer/renderer.py: lane_tables, a bijection of the
//        n = W*H lanes onto the pixels); W, H, the repeat factor s >= 1;
//   out: [H*s, W*s, 3] uint8, pixel (s*py + j, s*px + i) = rgb[lane] for
//        0 <= i, j < s. A lane whose pixel lies outside W x H writes
//        nothing.
//
// What bounds it on an H100: bytes. A lane reads 3 B of colour and 8 B of
// table and writes 3*s*s B: at 960x540 and s = 2 some 12 MB, 3.6 us at
// 3.35 TB/s (ops/image.py: io_bytes). No arithmetic to speak of. The
// design: a lane per thread, as the tables give; 32 neighbouring lanes lie
// on one row of a 32x32 block, so a warp's writes fill 32*3*s contiguous
// bytes of each of its s output rows.
//
// Bits: pure data movement, the host path's bytes exactly.
// Plain PyTorch version: ops/image.py, unswizzle_upscale_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    unswizzle_upscale_kernel(int64_t n, const uint8_t* __restrict__ rgb,
                             const int32_t* __restrict__ lane_px,
                             const int32_t* __restrict__ lane_py,
                             int32_t width, int32_t height, int32_t s,
                             uint8_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const int32_t px = lane_px[i];
  const int32_t py = lane_py[i];
  if (px < 0 || px >= width || py < 0 || py >= height) return;
  const uint8_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
  const int64_t row = static_cast<int64_t>(width) * s * 3;
  uint8_t* o = out + static_cast<int64_t>(py) * s * row +
               static_cast<int64_t>(px) * s * 3;
  for (int32_t j = 0; j < s; ++j, o += row) {
    for (int32_t k = 0; k < 3 * s; k += 3) {
      o[k] = r;
      o[k + 1] = g;
      o[k + 2] = b;
    }
  }
}

}  // namespace

// Launch the kernel on `stream` for n lanes; returns the launch's CUDA
// error (0 on success, nothing launched for n = 0), or -1 for a size that
// the kernel does not take (n != width*height, a repeat below 1).
extern "C" int tpt_unswizzle_upscale(int64_t n, const void* rgb,
                                     const void* lane_px,
                                     const void* lane_py, int32_t width,
                                     int32_t height, int32_t repeat,
                                     void* out, void* stream) {
  if (n != static_cast<int64_t>(width) * height || repeat < 1) return -1;
  if (n <= 0) return 0;
  const int64_t grid = (n + kBlock - 1) / kBlock;
  unswizzle_upscale_kernel<<<static_cast<unsigned>(grid), kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const uint8_t*>(rgb),
      static_cast<const int32_t*>(lane_px),
      static_cast<const int32_t*>(lane_py), width, height, repeat,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
