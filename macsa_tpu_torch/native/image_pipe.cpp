// Native host-side image pipeline: decode (libjpeg/libpng), antialiased
// bilinear resize, and ImageNet normalization.
//
// A copy of macsa_tpu/native/image_pipe.cpp for the PyTorch port: the
// replacement for the external native code the reference leans on for its
// data path (torchvision's C++ decode/transform stack and torch's C++
// DataLoader core; reference: vimacsa_dataset.py:25-30,123-199).  The
// Python loader (macsa_tpu_torch/data/loader.py) calls these through ctypes
// — the GIL is released for the duration of each call, so decode/resize
// work scales across loader threads on multi-core hosts.
//
// The one difference from the original: decode is a separate capability.
// Compiled with -DIP_NO_DECODE (a host without libjpeg/libpng headers) the
// library holds resize and normalize only, `ip_has_decode()` returns 0 and
// `ip_decode` always fails, so the caller takes its next decoder.
//
// Resize semantics: the triangle-filter resampling convolution that PIL /
// torchvision `Resize(..., antialias=True)` implement — per-axis support
// widened by the downscale factor, separable horizontal-then-vertical
// passes, double accumulation, round-half-up to u8.  This is the same
// *algorithm* as Pillow; outputs may differ from Pillow by ±2/255 (Pillow
// quantizes filter coefficients to fixed point).  tests/test_native.py pins
// both an exact numpy reference and the loose PIL tolerance.
//
// Build: g++ -O3 -fPIC -shared -fopenmp image_pipe.cpp -ljpeg -lpng
//    or: g++ -O3 -fPIC -shared -fopenmp -DIP_NO_DECODE image_pipe.cpp
//        (see macsa_tpu_torch/native/__init__.py: ensure_built()).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>

#ifndef IP_NO_DECODE
#include <jpeglib.h>
#include <png.h>
#endif

namespace {

#ifndef IP_NO_DECODE
// ---------------------------------------------------------------- decode --

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jump, 1);
}

// Decode a JPEG stream to RGB u8.  Returns nullptr on any failure
// (including CMYK sources, which libjpeg cannot convert to RGB).
uint8_t* decode_jpeg(FILE* f, int* h, int* w) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    // volatile: modified between setjmp and a possible longjmp (C99 7.13.2.1)
    uint8_t* volatile out = nullptr;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        free(out);
        return nullptr;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;  // YCbCr/grayscale -> RGB in-library
    jpeg_start_decompress(&cinfo);
    if (cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    const int H = cinfo.output_height, W = cinfo.output_width;
    out = static_cast<uint8_t*>(malloc(static_cast<size_t>(H) * W * 3));
    if (!out) {
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * W * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *h = H;
    *w = W;
    return out;
}

// Decode a PNG stream to RGB u8 (alpha stripped, like PIL convert("RGB")
// after its default un-premultiplied drop; palette/gray expanded).
uint8_t* decode_png(FILE* f, int* h, int* w) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) return nullptr;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return nullptr;
    }
    uint8_t* volatile out = nullptr;
    png_bytep* volatile rows = nullptr;
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        free(rows);
        free(out);
        return nullptr;
    }
    png_init_io(png, f);
    png_read_info(png, info);

    png_byte color = png_get_color_type(png, info);
    png_byte depth = png_get_bit_depth(png, info);
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
        png_set_gray_to_rgb(png);
    png_set_strip_alpha(png);
    png_read_update_info(png, info);

    const int H = png_get_image_height(png, info);
    const int W = png_get_image_width(png, info);
    if (png_get_rowbytes(png, info) != static_cast<size_t>(W) * 3) {
        png_destroy_read_struct(&png, &info, nullptr);
        return nullptr;
    }
    out = static_cast<uint8_t*>(malloc(static_cast<size_t>(H) * W * 3));
    rows = static_cast<png_bytep*>(malloc(sizeof(png_bytep) * H));
    if (!out || !rows) {
        png_destroy_read_struct(&png, &info, nullptr);
        free(rows);
        free(out);
        return nullptr;
    }
    for (int y = 0; y < H; ++y)
        rows[y] = out + static_cast<size_t>(y) * W * 3;
    png_read_image(png, rows);
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    free(rows);
    *h = H;
    *w = W;
    return out;
}

#endif  // IP_NO_DECODE

// ---------------------------------------------------------------- resize --

// Per-axis triangle-filter coefficient table.
struct Coeffs {
    int* bounds;      // [out] first source index
    int* counts;      // [out] number of taps
    double* weights;  // [out * ksize]
    int ksize;
};

Coeffs make_coeffs(int in_size, int out_size) {
    const double scale = static_cast<double>(in_size) / out_size;
    const double filterscale = scale < 1.0 ? 1.0 : scale;
    const double support = filterscale;  // triangle filter support = 1.0
    const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

    Coeffs c;
    c.ksize = ksize;
    c.bounds = static_cast<int*>(malloc(sizeof(int) * out_size));
    c.counts = static_cast<int*>(malloc(sizeof(int) * out_size));
    c.weights = static_cast<double*>(malloc(sizeof(double) * out_size * ksize));
    for (int i = 0; i < out_size; ++i) {
        const double center = (i + 0.5) * scale;
        int mn = static_cast<int>(std::floor(center - support));
        int mx = static_cast<int>(std::ceil(center + support));
        mn = std::max(mn, 0);
        mx = std::min(mx, in_size);
        double total = 0.0;
        double* w = c.weights + static_cast<size_t>(i) * ksize;
        for (int k = mn; k < mx; ++k) {
            const double x = std::fabs((k + 0.5 - center) / filterscale);
            const double v = x < 1.0 ? 1.0 - x : 0.0;
            w[k - mn] = v;
            total += v;
        }
        if (total > 0.0)
            for (int k = 0; k < mx - mn; ++k) w[k] /= total;
        c.bounds[i] = mn;
        c.counts[i] = mx - mn;
    }
    return c;
}

void free_coeffs(Coeffs& c) {
    free(c.bounds);
    free(c.counts);
    free(c.weights);
}

inline uint8_t round_u8(double v) {
    const int i = static_cast<int>(v + 0.5);
    return static_cast<uint8_t>(i < 0 ? 0 : (i > 255 ? 255 : i));
}

// Separable antialiased resize, u8 HWC RGB -> u8 HWC RGB.
void resize_triangle(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw) {
    if (sh == dh && sw == dw) {
        std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
        return;
    }
    Coeffs cx = make_coeffs(sw, dw);
    Coeffs cy = make_coeffs(sh, dh);
    // horizontal pass: [sh, dw, 3] double
    double* tmp =
        static_cast<double*>(malloc(sizeof(double) * static_cast<size_t>(sh) * dw * 3));
#pragma omp parallel for schedule(static) if (static_cast<size_t>(sh) * dw > 16384)
    for (int y = 0; y < sh; ++y) {
        const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
        double* trow = tmp + static_cast<size_t>(y) * dw * 3;
        for (int x = 0; x < dw; ++x) {
            const double* w = cx.weights + static_cast<size_t>(x) * cx.ksize;
            const int b = cx.bounds[x], n = cx.counts[x];
            double r = 0, g = 0, bl = 0;
            for (int k = 0; k < n; ++k) {
                const uint8_t* p = srow + static_cast<size_t>(b + k) * 3;
                r += w[k] * p[0];
                g += w[k] * p[1];
                bl += w[k] * p[2];
            }
            trow[x * 3 + 0] = r;
            trow[x * 3 + 1] = g;
            trow[x * 3 + 2] = bl;
        }
    }
    // vertical pass -> u8
#pragma omp parallel for schedule(static) if (static_cast<size_t>(dh) * dw > 16384)
    for (int y = 0; y < dh; ++y) {
        const double* w = cy.weights + static_cast<size_t>(y) * cy.ksize;
        const int b = cy.bounds[y], n = cy.counts[y];
        uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
        for (int x = 0; x < dw; ++x) {
            double r = 0, g = 0, bl = 0;
            for (int k = 0; k < n; ++k) {
                const double* p =
                    tmp + (static_cast<size_t>(b + k) * dw + x) * 3;
                r += w[k] * p[0];
                g += w[k] * p[1];
                bl += w[k] * p[2];
            }
            drow[x * 3 + 0] = round_u8(r);
            drow[x * 3 + 1] = round_u8(g);
            drow[x * 3 + 2] = round_u8(bl);
        }
    }
    free(tmp);
    free_coeffs(cx);
    free_coeffs(cy);
}

}  // namespace

extern "C" {

// Decode an image file (JPEG or PNG, sniffed by magic bytes) to RGB u8 HWC.
// Returns a malloc'ed buffer (free with ip_free) or nullptr on failure —
// unreadable/unsupported files fall back to the Python path
// (reference soft fault tolerance: vimacsa_dataset.py:130-135).
int ip_has_decode() {
#ifdef IP_NO_DECODE
    return 0;
#else
    return 1;
#endif
}

uint8_t* ip_decode(const char* path, int* h, int* w) {
#ifdef IP_NO_DECODE
    (void)path; (void)h; (void)w;
    return nullptr;
#else
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    unsigned char magic[8] = {0};
    const size_t got = fread(magic, 1, 8, f);
    rewind(f);
    uint8_t* out = nullptr;
    if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF)
        out = decode_jpeg(f, h, w);
    else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0)
        out = decode_png(f, h, w);
    fclose(f);
    return out;
#endif
}

void ip_free(uint8_t* p) { free(p); }

// Antialiased triangle-filter resize (PIL Resize(antialias) semantics).
void ip_resize_u8(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                  int dw) {
    resize_triangle(src, sh, sw, dst, dh, dw);
}

// u8 HWC [n, 3] pixels -> ImageNet-normalized float32: (x/255 - mean) / std.
void ip_normalize_f32(const uint8_t* src, long long n, float* dst,
                      const float* mean, const float* inv_std) {
#pragma omp parallel for schedule(static) if (n > 65536)
    for (long long i = 0; i < n; ++i) {
        const uint8_t* p = src + i * 3;
        float* q = dst + i * 3;
        q[0] = (p[0] * (1.0f / 255.0f) - mean[0]) * inv_std[0];
        q[1] = (p[1] * (1.0f / 255.0f) - mean[1]) * inv_std[1];
        q[2] = (p[2] * (1.0f / 255.0f) - mean[2]) * inv_std[2];
    }
}

// Fused resize + normalize: u8 [sh, sw, 3] -> f32 [dh, dw, 3].
void ip_resize_normalize_f32(const uint8_t* src, int sh, int sw, float* dst,
                             int dh, int dw, const float* mean,
                             const float* inv_std) {
    uint8_t* resized =
        static_cast<uint8_t*>(malloc(static_cast<size_t>(dh) * dw * 3));
    resize_triangle(src, sh, sw, resized, dh, dw);
    ip_normalize_f32(resized, static_cast<long long>(dh) * dw, dst, mean,
                     inv_std);
    free(resized);
}

}  // extern "C"
