// Fast JPEG decode + resize + center-crop for the feature-extraction host
// pipeline.
//
// The reference delegates decode to PIL inside torch DataLoader workers
// (engine/datasets/utils.py:153-174).  This decoder exploits libjpeg's
// IDCT scaling — decoding directly at 1/2, 3/8, 1/4... of full resolution
// costs a fraction of a full decode — then finishes with a separable
// Catmull-Rom bicubic (a = -0.5, PIL-compatible kernel) to the shorter-
// side target and center-crops.  Exposed through a C ABI consumed via
// ctypes (uml_tpu/native/__init__.py); no pybind11 dependency.
//
// Build: g++ -O3 -fPIC -shared -o libuml_jpeg.so jpeg_decoder.cpp -ljpeg

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Catmull-Rom cubic kernel (a = -0.5), the same family PIL's BICUBIC uses.
inline float cubic(float x) {
  constexpr float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// Separable bicubic resize, RGB interleaved uint8.
void resize_bicubic(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
                    int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;

  // horizontal pass into float intermediate [sh x dw x 3]
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int x = 0; x < dw; ++x) {
    const float center = (x + 0.5f) * sx - 0.5f;
    const int i0 = static_cast<int>(std::floor(center)) - 1;
    float w[4];
    float wsum = 0.0f;
    for (int k = 0; k < 4; ++k) {
      w[k] = cubic(center - (i0 + k));
      wsum += w[k];
    }
    for (int k = 0; k < 4; ++k) w[k] /= wsum;
    for (int y = 0; y < sh; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < 4; ++k) {
        const int xi = std::clamp(i0 + k, 0, sw - 1);
        const uint8_t* p = row + xi * 3;
        acc[0] += w[k] * p[0];
        acc[1] += w[k] * p[1];
        acc[2] += w[k] * p[2];
      }
      float* o = &tmp[(static_cast<size_t>(y) * dw + x) * 3];
      o[0] = acc[0];
      o[1] = acc[1];
      o[2] = acc[2];
    }
  }

  // vertical pass into dst [dh x dw x 3]
  for (int y = 0; y < dh; ++y) {
    const float center = (y + 0.5f) * sy - 0.5f;
    const int j0 = static_cast<int>(std::floor(center)) - 1;
    float w[4];
    float wsum = 0.0f;
    for (int k = 0; k < 4; ++k) {
      w[k] = cubic(center - (j0 + k));
      wsum += w[k];
    }
    for (int k = 0; k < 4; ++k) w[k] /= wsum;
    for (int x = 0; x < dw; ++x) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < 4; ++k) {
        const int yj = std::clamp(j0 + k, 0, sh - 1);
        const float* p = &tmp[(static_cast<size_t>(yj) * dw + x) * 3];
        acc[0] += w[k] * p[0];
        acc[1] += w[k] * p[1];
        acc[2] += w[k] * p[2];
      }
      uint8_t* o = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c)
        o[c] = static_cast<uint8_t>(
            std::clamp(acc[c] + 0.5f, 0.0f, 255.0f));
    }
  }
}

}  // namespace

extern "C" {

// Decode `jpeg[0:n]`, resize shorter side to `target`, center-crop
// target x target, write RGB uint8 into `out` (target*target*3 bytes).
// Returns 0 on success, negative on error.
int uml_decode_jpeg_resize_crop(const uint8_t* jpeg, size_t n, int target,
                                uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  // buffers live OUTSIDE the setjmp scope: longjmp skips destructors of
  // objects constructed after setjmp, so declaring them first lets the
  // normal return path free them after an error
  std::vector<uint8_t> decoded;
  std::vector<uint8_t> resized;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, jpeg, static_cast<unsigned long>(n));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }

  // IDCT scaling: pick the largest downscale (scale_num/8) that still
  // leaves the shorter side >= target, so the bicubic only downsamples.
  const int full_min = std::min<int>(cinfo.image_width, cinfo.image_height);
  int num = 8;
  while (num > 1 && (full_min * (num - 1)) / 8 >= target) --num;
  cinfo.scale_num = static_cast<unsigned>(num);
  cinfo.scale_denom = 8;
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_IFAST;

  const int full_w = cinfo.image_width;
  const int full_h = cinfo.image_height;
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width;
  const int sh = cinfo.output_height;
  decoded.resize(static_cast<size_t>(sw) * sh * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = decoded.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // resize shorter side to `target`; long side truncates like torchvision
  // Resize(int).  Target dims come from the FULL-resolution aspect ratio —
  // the IDCT-scaled intermediate can differ by a pixel in ratio.
  int dw, dh;
  if (full_w <= full_h) {
    dw = target;
    dh = std::max(target,
                  static_cast<int>(static_cast<double>(target) * full_h / full_w));
  } else {
    dh = target;
    dw = std::max(target,
                  static_cast<int>(static_cast<double>(target) * full_w / full_h));
  }
  resized.resize(static_cast<size_t>(dw) * dh * 3);
  resize_bicubic(decoded.data(), sw, sh, resized.data(), dw, dh);

  // center crop target x target
  const int top = std::max(0, (dh - target) / 2);
  const int left = std::max(0, (dw - target) / 2);
  for (int y = 0; y < target; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * target * 3,
                resized.data() + ((static_cast<size_t>(y + top) * dw) + left) * 3,
                static_cast<size_t>(target) * 3);
  }
  return 0;
}

}  // extern "C"
