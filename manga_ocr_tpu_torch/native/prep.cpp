// Native host-side page prep: fused orient + grayscale + edge-replicate pad
// (the port's copy of manga_ocr_tpu/native/prep.cpp).
//
// The serving host assembles each bucket batch before the host->device
// transfer (engine.ocr_page / ocr_pages).  The NumPy path costs three full
// passes with int32 temporaries (rot90 copy, gray convert, pad writes); this
// op reads each source pixel once and writes each batch byte once.  Gray
// math is the cv2 fixed-point formula, bit-identical to
// parallel/batching.gray_u8_np: y = (1868*b + 9617*g + 4899*r + 8192) >> 14
// on BGR input (the crops are cv2 BGR).
//
// Built by manga_ocr_tpu_torch/native/__init__.py into build/.

#include <cstdint>
#include <cstring>

namespace {

inline uint8_t gray_px(const uint8_t* p) {
  // p = BGR
  return static_cast<uint8_t>(
      (1868 * static_cast<int32_t>(p[0]) + 9617 * static_cast<int32_t>(p[1]) +
       4899 * static_cast<int32_t>(p[2]) + 8192) >>
      14);
}

}  // namespace

extern "C" {

// Fill one [bh, bw] gray batch row from a [h, w, ch] uint8 crop.
//  ch:  3 = BGR (gray-convert), 1 = already gray (copy).
//  rot: 0 = none, 1 = 90° CW (np.rot90 k=-1), 2 = 90° CCW (np.rot90 k=1) —
//       the reference's orientation rule (workers.py:318-327), applied to
//       the source read pattern so the rotated copy never materializes.
// Valid region after rotation is (w, h) for rot != 0; caller guarantees it
// fits (bh, bw).  Padding replicates the last valid column per row, then the
// last valid row (matching batching.bucket_crops exactly).
void prep_gray_row(const uint8_t* src, int32_t h, int32_t w, int32_t ch,
                   int32_t rot, uint8_t* dst, int32_t bh, int32_t bw) {
  const int32_t oh = rot ? w : h;
  const int32_t ow = rot ? h : w;
  if (oh <= 0 || ow <= 0) {  // degenerate crop: blank row, no OOB reads
    std::memset(dst, 0, static_cast<int64_t>(bh) * bw);
    return;
  }
  for (int32_t i = 0; i < oh; ++i) {
    uint8_t* drow = dst + static_cast<int64_t>(i) * bw;
    if (rot == 0) {
      const uint8_t* srow = src + static_cast<int64_t>(i) * w * ch;
      if (ch == 3) {
        for (int32_t j = 0; j < ow; ++j) drow[j] = gray_px(srow + 3 * j);
      } else {
        std::memcpy(drow, srow, ow);
      }
    } else if (rot == 1) {  // CW: out[i, j] = in[h-1-j, i]
      for (int32_t j = 0; j < ow; ++j) {
        const uint8_t* p =
            src + (static_cast<int64_t>(h - 1 - j) * w + i) * ch;
        drow[j] = ch == 3 ? gray_px(p) : *p;
      }
    } else {  // CCW: out[i, j] = in[j, w-1-i]
      for (int32_t j = 0; j < ow; ++j) {
        const uint8_t* p =
            src + (static_cast<int64_t>(j) * w + (w - 1 - i)) * ch;
        drow[j] = ch == 3 ? gray_px(p) : *p;
      }
    }
    if (ow < bw) std::memset(drow + ow, drow[ow - 1], bw - ow);
  }
  for (int32_t i = oh; i < bh; ++i) {
    std::memcpy(dst + static_cast<int64_t>(i) * bw,
                dst + static_cast<int64_t>(oh - 1) * bw, bw);
  }
}

// Batch entry: n crops into dst [n, bh, bw].
//  srcs: n contiguous uint8 crop pointers; dims: [n, 2] (h, w);
//  chs / rots: per-crop channel count and rotation code.
void prep_gray_batch(const uint8_t** srcs, const int32_t* dims,
                     const int32_t* chs, const int32_t* rots, int32_t n,
                     uint8_t* dst, int32_t bh, int32_t bw) {
  const int64_t stride = static_cast<int64_t>(bh) * bw;
  for (int32_t r = 0; r < n; ++r) {
    prep_gray_row(srcs[r], dims[2 * r], dims[2 * r + 1], chs[r], rots[r],
                  dst + r * stride, bh, bw);
  }
}

// Packed-wire entry (the engine's wire="packed"): n crops grayed + rotated
// into a flat buffer at per-crop offsets; the device rebuilds the padded
// batch with a clamped row gather (ops/preprocess.unpack_packed_page).
//  bw_pad == 0: TIGHT pack (offsets are element offsets; rows of length w).
//  bw_pad  > 0: ROW pack -- heights tight, each row edge-padded to bw_pad
//    (offsets are byte offsets == row_offset * bw_pad); the device gathers
//    whole rows.
void prep_gray_packed(const uint8_t** srcs, const int32_t* dims,
                      const int32_t* chs, const int32_t* rots,
                      const int64_t* offsets, int32_t n, uint8_t* dst,
                      int32_t bw_pad) {
  for (int32_t r = 0; r < n; ++r) {
    const int32_t h = dims[2 * r], w = dims[2 * r + 1];
    const int32_t oh = rots[r] ? w : h, ow = rots[r] ? h : w;
    // tight pack == pad target exactly the rotated dims; row pack == pad
    // width only (height stays oh either way)
    prep_gray_row(srcs[r], h, w, chs[r], rots[r], dst + offsets[r], oh,
                  bw_pad > 0 ? bw_pad : ow);
  }
}

}  // extern "C"
