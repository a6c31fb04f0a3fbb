// Native WSI tile reader: multi-threaded pyramidal-TIFF region decode.
//
// Role: the reference pipeline leans on OpenSlide (C) for WSI decode
// (reference pre_processing/patch_gen_hdf5.py, spatial_vis/visualize.py).
// This library supplies that capability for TIFF-based slides (SVS is a
// TIFF variant) without OpenSlide: libtiff tile decode (JPEG/LZW/deflate
// via libtiff codecs), a handle pool so independent regions decode on
// independent threads (no GIL, no shared TIFF* state), and batched
// region reads that feed the TPU feature-extraction pipeline.
//
// C ABI (ctypes-friendly):
//   str_open(path) -> handle | NULL
//   str_num_levels(h) -> int
//   str_level_size(h, level, &w, &h)
//   str_read_region(h, level, x, y, w, ht, out_rgb) -> 0 on success
//       (x, y are coordinates IN THAT LEVEL; out = w*ht*3 bytes, row-major)
//   str_read_regions(h, level, xs, ys, n, w, ht, out, nthreads) -> #ok
//   str_close(h)
//
// Build: make -C sequoia_tpu/native

#include <tiffio.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct LevelInfo {
  int dir;       // TIFF directory index
  uint32_t w, h;
};

struct Slide {
  std::string path;
  std::vector<LevelInfo> levels;  // sorted by width desc
  // Pool of per-thread TIFF handles (TIFF* is not thread-safe).
  std::mutex pool_mu;
  std::vector<TIFF*> pool;

  TIFF* acquire() {
    {
      std::lock_guard<std::mutex> g(pool_mu);
      if (!pool.empty()) {
        TIFF* t = pool.back();
        pool.pop_back();
        return t;
      }
    }
    return TIFFOpen(path.c_str(), "rm");
  }
  void release(TIFF* t) {
    std::lock_guard<std::mutex> g(pool_mu);
    pool.push_back(t);
  }
  ~Slide() {
    for (TIFF* t : pool) TIFFClose(t);
  }
};

// Copy the intersection of an RGBA tile/strip block with the request window
// into the RGB output. `raster` is TIFFReadRGBA* output: bottom-up rows.
void blit_rgba_bottomup(const uint32_t* raster, uint32_t bw, uint32_t bh,
                        int64_t bx, int64_t by,  // block origin in level coords
                        int64_t rx, int64_t ry, int64_t rw, int64_t rh,
                        uint8_t* out) {
  int64_t x0 = std::max(bx, rx), x1 = std::min<int64_t>(bx + bw, rx + rw);
  int64_t y0 = std::max(by, ry), y1 = std::min<int64_t>(by + bh, ry + rh);
  for (int64_t y = y0; y < y1; ++y) {
    // TIFFReadRGBATile raster row 0 is the BOTTOM row of the block.
    const uint32_t* src_row = raster + (bh - 1 - (y - by)) * bw;
    uint8_t* dst = out + ((y - ry) * rw + (x0 - rx)) * 3;
    for (int64_t x = x0; x < x1; ++x) {
      uint32_t px = src_row[x - bx];
      dst[0] = TIFFGetR(px);
      dst[1] = TIFFGetG(px);
      dst[2] = TIFFGetB(px);
      dst += 3;
    }
  }
}

// Row-memcpy blit for tiles already decoded as top-down 8-bit RGB.
void blit_rgb_topdown(const uint8_t* tilebuf, uint32_t bw, int64_t bx,
                      int64_t by, int64_t x0, int64_t x1, int64_t y0,
                      int64_t y1, int64_t rx, int64_t ry, int64_t rw,
                      uint8_t* out) {
  for (int64_t y = y0; y < y1; ++y) {
    std::memcpy(out + ((y - ry) * rw + (x0 - rx)) * 3,
                tilebuf + ((y - by) * bw + (x0 - bx)) * 3, (x1 - x0) * 3);
  }
}

// True when TIFFReadEncodedTile yields top-down 8-bit RGB directly, so the
// RGBA round-trip (TIFFReadRGBATile: 4-byte pixels, bottom-up rows,
// per-pixel channel shuffling) can be skipped.  Covers plain RGB tiles and
// JPEG-compressed YCbCr (Aperio SVS) via libtiff's JPEGCOLORMODE_RGB.
bool direct_rgb8_tiles(TIFF* tif) {
  uint16_t photometric = 0, spp = 0, bps = 0, planar = 0, compression = 0;
  uint16_t orient = ORIENTATION_TOPLEFT;
  TIFFGetFieldDefaulted(tif, TIFFTAG_PHOTOMETRIC, &photometric);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PLANARCONFIG, &planar);
  TIFFGetFieldDefaulted(tif, TIFFTAG_COMPRESSION, &compression);
  TIFFGetFieldDefaulted(tif, TIFFTAG_ORIENTATION, &orient);
  // non-TOPLEFT images must take the RGBA path (which honors the tag);
  // the raw memcpy blit would render them flipped
  if (orient != ORIENTATION_TOPLEFT) return false;
  if (spp != 3 || bps != 8 || planar != PLANARCONFIG_CONTIG) return false;
  if (photometric == PHOTOMETRIC_RGB) return true;
  if (photometric == PHOTOMETRIC_YCBCR && compression == COMPRESSION_JPEG) {
    TIFFSetField(tif, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
    return true;
  }
  return false;
}

int read_region_impl(TIFF* tif, const LevelInfo& lv, int64_t rx, int64_t ry,
                     int64_t rw, int64_t rh, uint8_t* out) {
  if (!TIFFSetDirectory(tif, lv.dir)) return -1;
  std::memset(out, 0, static_cast<size_t>(rw) * rh * 3);

  if (TIFFIsTiled(tif)) {
    uint32_t tw = 0, th = 0;
    TIFFGetField(tif, TIFFTAG_TILEWIDTH, &tw);
    TIFFGetField(tif, TIFFTAG_TILELENGTH, &th);
    if (!tw || !th) return -2;
    // sanity-cap hostile/corrupt tile dims before they size allocations
    if ((uint64_t)tw * th > (1ull << 28)) return -2;
    const bool fast = direct_rgb8_tiles(tif);
    std::vector<uint8_t> rgb;
    if (fast) rgb.resize(static_cast<size_t>(tw) * th * 3);
    std::vector<uint32_t> raster;
    int64_t tx0 = std::max<int64_t>(0, rx / tw) * tw;
    int64_t ty0 = std::max<int64_t>(0, ry / th) * th;
    for (int64_t ty = ty0; ty < ry + rh && ty < (int64_t)lv.h; ty += th) {
      if (ty + (int64_t)th <= ry) continue;
      for (int64_t tx = tx0; tx < rx + rw && tx < (int64_t)lv.w; tx += tw) {
        if (tx + (int64_t)tw <= rx) continue;
        if (fast) {
          tmsize_t n = TIFFReadEncodedTile(
              tif, TIFFComputeTile(tif, (uint32_t)tx, (uint32_t)ty, 0, 0),
              rgb.data(), rgb.size());
          // require the FULL tile: a short decode (truncated file) would
          // blit the previous tile's stale bytes from the reused buffer
          if (n == (tmsize_t)rgb.size()) {
            // edge tiles decode the full tw x th block with garbage beyond
            // the image edge; clamp the blit to level AND request bounds.
            int64_t x0 = std::max(tx, rx);
            int64_t x1 = std::min({tx + (int64_t)tw, rx + rw, (int64_t)lv.w});
            int64_t y0 = std::max(ty, ry);
            int64_t y1 = std::min({ty + (int64_t)th, ry + rh, (int64_t)lv.h});
            if (x0 < x1 && y0 < y1)
              blit_rgb_topdown(rgb.data(), tw, tx, ty, x0, x1, y0, y1, rx, ry,
                               rw, out);
            continue;
          }
          // decode failure or short read -> tolerant RGBA path
        }
        if (raster.empty()) raster.resize(static_cast<size_t>(tw) * th);
        if (!TIFFReadRGBATile(tif, (uint32_t)tx, (uint32_t)ty, raster.data()))
          continue;  // unreadable tile -> leave zeros (per-tile quarantine)
        // edge tiles: raster is still tw x th with garbage beyond the edge;
        // clamp the blit to the level bounds.
        uint32_t bw = tw, bh = th;
        blit_rgba_bottomup(raster.data(), bw, bh, tx, ty, rx, ry, rw, rh, out);
      }
    }
    return 0;
  }

  // Stripped image: decode intersecting strips.
  uint32_t rows_per_strip = 0;
  TIFFGetFieldDefaulted(tif, TIFFTAG_ROWSPERSTRIP, &rows_per_strip);
  // missing tag defaults to 0xFFFFFFFF ("infinity" = single strip), which
  // would size the raster at w * 4G pixels — clamp to the image height
  if (!rows_per_strip || rows_per_strip > lv.h) rows_per_strip = lv.h;
  std::vector<uint32_t> raster(static_cast<size_t>(lv.w) * rows_per_strip);
  int64_t s0 = (ry / rows_per_strip) * rows_per_strip;
  for (int64_t sy = s0; sy < ry + rh && sy < (int64_t)lv.h;
       sy += rows_per_strip) {
    uint32_t nrows = std::min<uint32_t>(rows_per_strip, lv.h - (uint32_t)sy);
    if (!TIFFReadRGBAStrip(tif, (uint32_t)sy, raster.data())) continue;
    blit_rgba_bottomup(raster.data(), lv.w, nrows, 0, sy, rx, ry, rw, rh, out);
  }
  return 0;
}

// Exception barrier: nothing may cross the extern "C" boundary (a
// std::bad_alloc from a corrupt file would std::terminate the Python
// process through ctypes).
int read_region_with(TIFF* tif, const LevelInfo& lv, int64_t rx, int64_t ry,
                     int64_t rw, int64_t rh, uint8_t* out) {
  try {
    return read_region_impl(tif, lv, rx, ry, rw, rh, out);
  } catch (...) {
    return -4;
  }
}

}  // namespace

extern "C" {

void* str_open(const char* path) {
  TIFFSetErrorHandler(nullptr);    // quiet: per-tile errors are tolerated
  TIFFSetWarningHandler(nullptr);
  TIFF* tif = TIFFOpen(path, "rm");
  if (!tif) return nullptr;
  auto* s = new Slide();
  s->path = path;
  int dir = 0;
  double aspect0 = 0.0;
  do {
    uint32_t w = 0, h = 0;
    TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &w);
    TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &h);
    if (w && h) {
      // SVS files carry associated images (label/macro/thumbnail) as extra
      // directories; treating them as pyramid levels would hand the tissue
      // masker a photo of the slide label.  Pyramid levels in SVS (and our
      // own writer) are TILED and share level 0's aspect ratio; associated
      // images are stripped and/or differently shaped — keep dir 0 always,
      // later dirs only when tiled with a matching aspect (5% tolerance).
      double aspect = (double)w / (double)h;
      bool keep = s->levels.empty() ||
                  (TIFFIsTiled(tif) &&
                   std::abs(aspect - aspect0) / aspect0 < 0.05);
      if (s->levels.empty()) aspect0 = aspect;
      if (keep) s->levels.push_back({dir, w, h});
    }
    ++dir;
  } while (TIFFReadDirectory(tif));
  std::sort(s->levels.begin(), s->levels.end(),
            [](const LevelInfo& a, const LevelInfo& b) { return a.w > b.w; });
  s->pool.push_back(tif);
  if (s->levels.empty()) {
    delete s;
    return nullptr;
  }
  return s;
}

int str_num_levels(void* handle) {
  return (int)static_cast<Slide*>(handle)->levels.size();
}

void str_level_size(void* handle, int level, int* w, int* h) {
  auto* s = static_cast<Slide*>(handle);
  if (level < 0 || level >= (int)s->levels.size()) {
    *w = *h = 0;
    return;
  }
  *w = (int)s->levels[level].w;
  *h = (int)s->levels[level].h;
}

// Tile geometry of `level`: returns 1 and sets (*tw, *th) when the level
// is tiled, else 0.  Lets callers plan tile-granular raw reads (the mosaic
// serving path assembles patches from whole raw-YCbCr tiles when the tile
// dims differ from the patch size — the layout of real Aperio slides,
// 240px tiles vs 256px patches).
int str_tile_dims(void* handle, int level, int* tw, int* th) {
  *tw = *th = 0;
  auto* s = static_cast<Slide*>(handle);
  if (level < 0 || level >= (int)s->levels.size()) return 0;
  TIFF* tif = s->acquire();
  if (!tif) return 0;
  int rc = 0;
  try {
    if (TIFFSetDirectory(tif, s->levels[level].dir) && TIFFIsTiled(tif)) {
      uint32_t w = 0, h = 0;
      TIFFGetField(tif, TIFFTAG_TILEWIDTH, &w);
      TIFFGetField(tif, TIFFTAG_TILELENGTH, &h);
      if (w && h) {
        *tw = (int)w;
        *th = (int)h;
        rc = 1;
      }
    }
  } catch (...) {
    rc = 0;
  }
  s->release(tif);
  return rc;
}

int str_read_region(void* handle, int level, int64_t x, int64_t y,
                    int64_t w, int64_t h, uint8_t* out) {
  auto* s = static_cast<Slide*>(handle);
  if (level < 0 || level >= (int)s->levels.size()) return -1;
  TIFF* tif = s->acquire();
  if (!tif) return -3;
  int rc = read_region_with(tif, s->levels[level], x, y, w, h, out);
  s->release(tif);
  return rc;
}

// Batched parallel region decode: n regions of identical (w, h) at level
// coords (xs[i], ys[i]) -> out[i * w * h * 3].  Returns the number decoded.
int str_read_regions(void* handle, int level, const int64_t* xs,
                     const int64_t* ys, int n, int64_t w, int64_t h,
                     uint8_t* out, int nthreads) {
  auto* s = static_cast<Slide*>(handle);
  if (level < 0 || level >= (int)s->levels.size()) return 0;
  if (nthreads < 1) nthreads = 1;
  nthreads = std::min(nthreads, n);

  std::atomic<int> next(0), ok(0);
  auto worker = [&]() {
    TIFF* tif = s->acquire();
    if (!tif) return;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (read_region_with(tif, s->levels[level], xs[i], ys[i], w, h,
                           out + (size_t)i * w * h * 3) == 0)
        ok.fetch_add(1);
    }
    s->release(tif);
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

void str_close(void* handle) { delete static_cast<Slide*>(handle); }

// ---------------------------------------------------------------------------
// Raw subsampled-YCbCr tile reads.
//
// JPEG tiles store YCbCr with chroma subsampling (2x2 for our writer and
// most Aperio slides): 1.5 bytes/pixel instead of the 3 bytes/pixel the
// RGB path expands to.  Serving uploads patches over host->device links
// (PCIe on a real v5e host); shipping the raw subsampled planes and doing
// the upsample + color conversion on the TPU halves that traffic AND skips
// libjpeg's host-side upsample/convert work.  The device-side conversion
// (sequoia_tpu/ops/ycbcr.py) reproduces libjpeg's integer math bit-exactly,
// so this path returns pixels identical to the RGB path.
//
// Scope: whole-tile requests only (region == one full tile, tile-aligned,
// fully inside the level).  Arbitrary regions would need upsampling context
// across tile boundaries, which libjpeg itself does not have (each TIFF
// tile is an independent JPEG image) — per-tile requests keep the
// device-side conversion bit-exact.  Callers probe with str_ycbcr_ok and
// fall back to str_read_regions otherwise.

namespace {

// Check tiles at `level` are JPEG YCbCr with integral subsampling and tile
// dims == (w, h); returns 1 and sets (*sh, *sv) on success.
int ycbcr_ok_impl(TIFF* tif, const LevelInfo& lv, int64_t w, int64_t h,
                  int* sh, int* sv) {
  if (!TIFFSetDirectory(tif, lv.dir) || !TIFFIsTiled(tif)) return 0;
  uint32_t tw = 0, th = 0;
  TIFFGetField(tif, TIFFTAG_TILEWIDTH, &tw);
  TIFFGetField(tif, TIFFTAG_TILELENGTH, &th);
  if ((int64_t)tw != w || (int64_t)th != h) return 0;
  uint16_t photometric = 0, spp = 0, bps = 0, planar = 0, compression = 0;
  uint16_t orient = ORIENTATION_TOPLEFT;
  TIFFGetFieldDefaulted(tif, TIFFTAG_PHOTOMETRIC, &photometric);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PLANARCONFIG, &planar);
  TIFFGetFieldDefaulted(tif, TIFFTAG_COMPRESSION, &compression);
  TIFFGetFieldDefaulted(tif, TIFFTAG_ORIENTATION, &orient);
  if (photometric != PHOTOMETRIC_YCBCR || compression != COMPRESSION_JPEG ||
      spp != 3 || bps != 8 || planar != PLANARCONFIG_CONTIG ||
      orient != ORIENTATION_TOPLEFT)
    return 0;
  uint16_t s_h = 2, s_v = 2;
  TIFFGetFieldDefaulted(tif, TIFFTAG_YCBCRSUBSAMPLING, &s_h, &s_v);
  // (2,2)=4:2:0 and (1,1)=4:4:4 decode through libtiff's raw mode;
  // (2,1)=4:2:2 (Aperio GT450 slides) takes the libjpeg-direct path below,
  // because this libtiff's raw mode is internally inconsistent there:
  // JPEGDecodeRaw advances by TIFFScanlineSize (1024 B/row for a 256px
  // 4:2:2 tile) while TIFFReadEncodedTile clamps the buffer to
  // TIFFTileSize (512 B/row), so the decode always fails partway —
  // measured empirically.  Other factors (e.g. 1x2) lack a libjpeg
  // fancy-upsample equivalent for the device-side bit-exact
  // reconstruction and take the RGB path.
  if (!((s_h == 2 && s_v == 2) || (s_h == 1 && s_v == 1) ||
        (s_h == 2 && s_v == 1)))
    return 0;
  if (w % s_h || h % s_v) return 0;
  *sh = s_h;
  *sv = s_v;
  return 1;
}

// libjpeg error hook: the default handler exit()s the process; longjmp
// back to the per-tile decode instead (per-tile quarantine semantics).
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf env;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->env, 1);
}

// Decode ONE whole tile's raw subsampled planes by handing the tile's JPEG
// codestream (TIFFReadRawTile bytes, prefixed by the directory's
// abbreviated JPEGTables stream) to libjpeg directly and reading
// jpeg_read_raw_data output.  This bypasses libtiff's raw mode, which is
// internally inconsistent for 4:2:2 (see ycbcr_ok_impl) — the layout of
// Aperio GT450 slides.  Output layout matches read_tile_ycbcr_impl:
// planar Y (w*h) ++ Cb ++ Cr ((w/sh)*(h/sv) each).
int read_tile_ycbcr_jpegdirect(TIFF* tif, int64_t rx, int64_t ry, int64_t w,
                               int64_t h, int sh, int sv, uint8_t* out) {
  // raw codestream bytes of this tile
  uint32_t tile = TIFFComputeTile(tif, (uint32_t)rx, (uint32_t)ry, 0, 0);
  uint64_t* counts = nullptr;
  if (!TIFFGetField(tif, TIFFTAG_TILEBYTECOUNTS, &counts) || !counts)
    return -5;
  uint64_t rawsz = counts[tile];
  if (!rawsz || rawsz > (1ull << 28)) return -5;
  std::vector<uint8_t> raw((size_t)rawsz);
  tmsize_t got = TIFFReadRawTile(tif, tile, raw.data(), (tmsize_t)rawsz);
  if (got <= 0) return -5;
  // shared quantization/Huffman tables (TIFF stores them once per
  // directory as an abbreviated tables-only JPEG stream)
  uint32_t tlen = 0;
  void* tdata = nullptr;
  TIFFGetField(tif, TIFFTAG_JPEGTABLES, &tlen, &tdata);

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  // declared before setjmp so a longjmp'd return still destructs them
  std::vector<uint8_t> plane[3];
  std::vector<JSAMPROW> rp[3];
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return -6;
  }
  jpeg_create_decompress(&cinfo);
  if (tdata && tlen > 4) {
    jpeg_mem_src(&cinfo, (const unsigned char*)tdata, tlen);
    if (jpeg_read_header(&cinfo, FALSE) != JPEG_HEADER_TABLES_ONLY) {
      jpeg_destroy_decompress(&cinfo);
      return -6;
    }
  }
  jpeg_mem_src(&cinfo, raw.data(), (unsigned long)got);
  jpeg_read_header(&cinfo, TRUE);
  // the stream must be exactly the probed tile layout — the RGB-path
  // oracle (libtiff JPEGCOLORMODE_RGB) enforces the same dims, so bit-
  // exactness is only defined under these conditions
  if (cinfo.num_components != 3 || cinfo.data_precision != 8 ||
      cinfo.jpeg_color_space != JCS_YCbCr ||
      cinfo.image_width != (JDIMENSION)w ||
      cinfo.image_height != (JDIMENSION)h ||
      cinfo.comp_info[0].h_samp_factor != sh ||
      cinfo.comp_info[0].v_samp_factor != sv ||
      cinfo.comp_info[1].h_samp_factor != 1 ||
      cinfo.comp_info[1].v_samp_factor != 1 ||
      cinfo.comp_info[2].h_samp_factor != 1 ||
      cinfo.comp_info[2].v_samp_factor != 1) {
    jpeg_destroy_decompress(&cinfo);
    return -6;
  }
  cinfo.raw_data_out = TRUE;
  cinfo.out_color_space = JCS_YCbCr;
  jpeg_start_decompress(&cinfo);

  // jpeg_read_raw_data consumes one iMCU row (max_v_samp * 8 image lines)
  // per call and requires each component's rows to span width_in_blocks*8
  // samples — decode into padded planes, then copy the valid region out.
  const int mcu_h = cinfo.max_v_samp_factor * DCTSIZE;
  const int ncalls = (int)((h + mcu_h - 1) / mcu_h);
  size_t prow[3];
  int crows[3];
  JSAMPARRAY arr[3];
  for (int ci = 0; ci < 3; ++ci) {
    prow[ci] = (size_t)cinfo.comp_info[ci].width_in_blocks * DCTSIZE;
    crows[ci] = cinfo.comp_info[ci].v_samp_factor * DCTSIZE;
    plane[ci].resize(prow[ci] * crows[ci] * ncalls);
    rp[ci].resize(crows[ci]);
    arr[ci] = rp[ci].data();
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    size_t call = cinfo.output_scanline / mcu_h;
    for (int ci = 0; ci < 3; ++ci)
      for (int r = 0; r < crows[ci]; ++r)
        rp[ci][r] =
            plane[ci].data() + (call * crows[ci] + r) * prow[ci];
    if (jpeg_read_raw_data(&cinfo, arr, mcu_h) == 0) {
      jpeg_destroy_decompress(&cinfo);
      return -6;
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  const int64_t cw = w / sh, ch = h / sv;
  uint8_t* yp = out;
  uint8_t* cbp = out + (size_t)w * h;
  uint8_t* crp = cbp + (size_t)cw * ch;
  for (int64_t y = 0; y < h; ++y)
    std::memcpy(yp + y * w, plane[0].data() + (size_t)y * prow[0], w);
  for (int64_t y = 0; y < ch; ++y) {
    std::memcpy(cbp + y * cw, plane[1].data() + (size_t)y * prow[1], cw);
    std::memcpy(crp + y * cw, plane[2].data() + (size_t)y * prow[2], cw);
  }
  return 0;
}

// Decode ONE whole tile at (rx, ry) as raw YCbCr and repack the TIFF
// clump-interleaved layout (per sh x sv unit: Y samples row-major, Cb, Cr)
// into planar Y (w*h) ++ Cb (cw*ch) ++ Cr (cw*ch).
//
// Edge tiles (the level's last tile column/row on non-multiple dims) are
// stored full-size with encoder padding beyond the image edge; they decode
// here as-is, and the CALLER masks pixels beyond the level bounds to black
// after reconstruction (sequoia_tpu/serve.py passes per-tile valid (w, h)
// into the device program) so the result stays bit-exact with the RGB
// path's zero-fill.
// Precondition (hoisted out of the per-tile hot loop): the caller has
// already validated the layout with ycbcr_ok_impl on THIS handle (which
// also sets the directory) and, for the libtiff raw path, armed
// JPEGCOLORMODE_RAW once — str_read_regions_ycbcr does both per worker.
int read_tile_ycbcr_impl(TIFF* tif, const LevelInfo& lv, int64_t rx,
                         int64_t ry, int64_t w, int64_t h, int sh, int sv,
                         uint8_t* out) {
  if (rx % w || ry % h) return -2;                       // tile-aligned only
  if (rx < 0 || ry < 0 || rx >= lv.w || ry >= lv.h) return -2;
  // 4:2:2 cannot use libtiff's raw mode (see ycbcr_ok_impl) — decode the
  // tile's JPEG stream directly
  if (sh == 2 && sv == 1)
    return read_tile_ycbcr_jpegdirect(tif, rx, ry, w, h, sh, sv, out);
  const int64_t cw = w / sh, ch = h / sv;
  const size_t clump = (size_t)sh * sv + 2;
  const size_t packed_size = (size_t)(w / sh) * (h / sv) * clump;
  std::vector<uint8_t> packed(packed_size);
  tmsize_t n = TIFFReadEncodedTile(
      tif, TIFFComputeTile(tif, (uint32_t)rx, (uint32_t)ry, 0, 0),
      packed.data(), packed.size());
  if (n != (tmsize_t)packed.size()) return -3;
  uint8_t* yp = out;
  uint8_t* cbp = out + (size_t)w * h;
  uint8_t* crp = cbp + (size_t)cw * ch;
  const uint8_t* src = packed.data();
  if (sh == 2 && sv == 2) {
    // 4:2:0 fast path: per clump row, walk four row pointers linearly
    for (int64_t cy = 0; cy < ch; ++cy) {
      uint8_t* y0 = yp + (2 * cy) * w;
      uint8_t* y1 = y0 + w;
      uint8_t* cbr = cbp + cy * cw;
      uint8_t* crr = crp + cy * cw;
      for (int64_t cx = 0; cx < cw; ++cx) {
        y0[0] = src[0];
        y0[1] = src[1];
        y1[0] = src[2];
        y1[1] = src[3];
        *cbr++ = src[4];
        *crr++ = src[5];
        y0 += 2;
        y1 += 2;
        src += 6;
      }
    }
    return 0;
  }
  for (int64_t cy = 0; cy < ch; ++cy) {
    for (int64_t cx = 0; cx < cw; ++cx) {
      for (int vy = 0; vy < sv; ++vy)
        for (int vx = 0; vx < sh; ++vx)
          yp[(cy * sv + vy) * w + cx * sh + vx] = src[vy * sh + vx];
      cbp[cy * cw + cx] = src[clump - 2];
      crp[cy * cw + cx] = src[clump - 1];
      src += clump;
    }
  }
  return 0;
}

int read_tile_ycbcr_with(TIFF* tif, const LevelInfo& lv, int64_t rx,
                         int64_t ry, int64_t w, int64_t h, int sh, int sv,
                         uint8_t* out) {
  try {
    return read_tile_ycbcr_impl(tif, lv, rx, ry, w, h, sh, sv, out);
  } catch (...) {
    return -4;
  }
}

}  // namespace

// Probe whether whole-(w, h)-tile requests at `level` can use the raw
// path; sets (*sh, *sv) to the chroma subsampling on success.
int str_ycbcr_ok(void* handle, int level, int64_t w, int64_t h, int* sh,
                 int* sv) {
  auto* s = static_cast<Slide*>(handle);
  if (level < 0 || level >= (int)s->levels.size()) return 0;
  TIFF* tif = s->acquire();
  if (!tif) return 0;
  int rc = 0;
  try {
    rc = ycbcr_ok_impl(tif, s->levels[level], w, h, sh, sv);
  } catch (...) {
    rc = 0;
  }
  s->release(tif);
  return rc;
}

// Batched parallel raw-YCbCr whole-tile decode: n tiles of (w, h) at
// tile-aligned level coords -> out[i * (w*h + 2*(w/sh)*(h/sv))], each
// region planar Y ++ Cb ++ Cr.  Returns the number decoded; callers treat
// ok != n as a hard failure (no silent black tiles).
int str_read_regions_ycbcr(void* handle, int level, const int64_t* xs,
                           const int64_t* ys, int n, int64_t w, int64_t h,
                           uint8_t* out, int nthreads) {
  auto* s = static_cast<Slide*>(handle);
  if (level < 0 || level >= (int)s->levels.size()) return 0;
  int sh = 0, sv = 0;
  if (!str_ycbcr_ok(handle, level, w, h, &sh, &sv)) return 0;
  const size_t stride = (size_t)w * h + 2 * (size_t)(w / sh) * (h / sv);
  if (nthreads < 1) nthreads = 1;
  nthreads = std::min(nthreads, n);

  std::atomic<int> next(0), ok(0);
  auto worker = [&]() {
    TIFF* tif = s->acquire();
    if (!tif) return;
    // validate the layout ONCE per worker handle (sets the directory);
    // per-tile work is then just alignment checks + decode
    int wsh = 0, wsv = 0;
    bool armed = false;
    try {
      armed = ycbcr_ok_impl(tif, s->levels[level], w, h, &wsh, &wsv) != 0;
    } catch (...) {
      armed = false;
    }
    if (armed && !(wsh == 2 && wsv == 1))
      TIFFSetField(tif, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RAW);
    while (armed) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (read_tile_ycbcr_with(tif, s->levels[level], xs[i], ys[i], w, h,
                               wsh, wsv, out + (size_t)i * stride) == 0)
        ok.fetch_add(1);
    }
    s->release(tif);
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

// Copy the level-0 ImageDescription (Aperio SVS metadata like
// "...|AppMag = 40|...") into `buf`; returns the string length or 0.
int str_description(void* handle, char* buf, int buflen) {
  if (buflen <= 0) return 0;  // (size_t)buflen - 1 would wrap to SIZE_MAX
  auto* s = static_cast<Slide*>(handle);
  TIFF* tif = s->acquire();
  if (!tif) return 0;
  int out = 0;
  if (TIFFSetDirectory(tif, s->levels[0].dir)) {
    char* desc = nullptr;
    if (TIFFGetField(tif, TIFFTAG_IMAGEDESCRIPTION, &desc) && desc) {
      out = (int)std::min<size_t>(std::strlen(desc), (size_t)buflen - 1);
      std::memcpy(buf, desc, out);
      buf[out] = 0;
    }
  }
  s->release(tif);
  return out;
}

// Test/dev helper: write `levels` RGB images as a tiled multi-directory
// TIFF (tile size tw x th).  `jpeg_quality` > 0 writes JPEG-compressed
// YCbCr tiles (2x2 subsampling) — the on-disk layout of real Aperio SVS
// slides (reference pre_processing/patch_gen_hdf5.py reads these through
// OpenSlide) — so fixtures can exercise the exact decode path production
// slides take; 0 writes uncompressed RGB.  `description`, when non-empty,
// is stored as level 0's ImageDescription (Aperio-style
// "...|AppMag = 20|MPP = 0.5" metadata that str_description parses back).
int str_write_tiled_ex2(const char* path, const uint8_t* const* bufs,
                        const int64_t* ws, const int64_t* hs, int n_levels,
                        int tw, int th, int jpeg_quality,
                        const char* description, int sub_h, int sub_v) {
  if (sub_h < 1 || sub_h > 2 || sub_v < 1 || sub_v > 2) return -5;
  if (jpeg_quality > 0 && (tw % 16 || th % 16))
    return -4;  // JPEG 2x2-subsampled MCUs need multiple-of-16 tiles
  TIFF* tif = TIFFOpen(path, "w");
  if (!tif) return -1;
  std::vector<uint8_t> tile((size_t)tw * th * 3);
  for (int lv = 0; lv < n_levels; ++lv) {
    int64_t w = ws[lv], h = hs[lv];
    TIFFSetField(tif, TIFFTAG_IMAGEWIDTH, (uint32_t)w);
    TIFFSetField(tif, TIFFTAG_IMAGELENGTH, (uint32_t)h);
    TIFFSetField(tif, TIFFTAG_SAMPLESPERPIXEL, 3);
    TIFFSetField(tif, TIFFTAG_BITSPERSAMPLE, 8);
    TIFFSetField(tif, TIFFTAG_ORIENTATION, ORIENTATION_TOPLEFT);
    TIFFSetField(tif, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
    if (jpeg_quality > 0) {
      TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_JPEG);
      TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_YCBCR);
      TIFFSetField(tif, TIFFTAG_YCBCRSUBSAMPLING, (uint16_t)sub_h,
                   (uint16_t)sub_v);
      TIFFSetField(tif, TIFFTAG_JPEGQUALITY, jpeg_quality);
      // hand libtiff RGB rows; it converts to YCbCr for the codec
      TIFFSetField(tif, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
    } else {
      TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
    }
    if (lv == 0 && description && description[0])
      TIFFSetField(tif, TIFFTAG_IMAGEDESCRIPTION, description);
    TIFFSetField(tif, TIFFTAG_TILEWIDTH, (uint32_t)tw);
    TIFFSetField(tif, TIFFTAG_TILELENGTH, (uint32_t)th);
    for (int64_t ty = 0; ty < h; ty += th) {
      for (int64_t tx = 0; tx < w; tx += tw) {
        std::memset(tile.data(), 0, tile.size());
        for (int64_t y = ty; y < std::min<int64_t>(ty + th, h); ++y) {
          const uint8_t* src = bufs[lv] + (y * w + tx) * 3;
          int64_t ncols = std::min<int64_t>(tw, w - tx);
          std::memcpy(tile.data() + (y - ty) * tw * 3, src, ncols * 3);
        }
        if (TIFFWriteTile(tif, tile.data(), (uint32_t)tx, (uint32_t)ty, 0,
                          0) < 0) {
          TIFFClose(tif);
          return -2;
        }
      }
    }
    if (!TIFFWriteDirectory(tif)) {
      TIFFClose(tif);
      return -3;
    }
  }
  TIFFClose(tif);
  return 0;
}

int str_write_tiled_ex(const char* path, const uint8_t* const* bufs,
                       const int64_t* ws, const int64_t* hs, int n_levels,
                       int tw, int th, int jpeg_quality,
                       const char* description) {
  return str_write_tiled_ex2(path, bufs, ws, hs, n_levels, tw, th,
                             jpeg_quality, description, 2, 2);
}

int str_write_tiled(const char* path, const uint8_t* const* bufs,
                    const int64_t* ws, const int64_t* hs, int n_levels,
                    int tw, int th) {
  return str_write_tiled_ex(path, bufs, ws, hs, n_levels, tw, th, 0, "");
}

}  // extern "C"
