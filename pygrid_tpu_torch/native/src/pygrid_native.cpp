// Native runtime kernels for the host-side hot paths.
//
// Parity rationale: the reference's serving plane leans on native code for
// exactly these spots — wsaccel (C websocket masking, apps/node/
// pyproject.toml:31) plus a numpy XOR patch (apps/node/src/app/util.py:5-24),
// and protobuf's C++ for tensor payload packing. Here the equivalents are a
// word-wide XOR mask and float32<->bfloat16 wire conversion (TPU-native
// payload dtype), exported with a plain C ABI for ctypes.
//
// Build: pygrid_tpu_torch/native/build.py shells out to g++ -O3 -shared -fPIC
// (this file is the port's copy of pygrid_tpu/native/src/pygrid_native.cpp).

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// XOR-mask `n` bytes of `buf` in place with the 4-byte websocket mask.
// Word-wide main loop (the per-byte tail is at most 7 iterations); with -O3
// the 64-bit loop auto-vectorizes.
void pg_xor_mask(uint8_t *buf, uint64_t n, const uint8_t mask[4]) {
    uint64_t wide;
    uint8_t rep[8];
    for (int i = 0; i < 8; ++i) rep[i] = mask[i & 3];
    std::memcpy(&wide, rep, 8);

    uint64_t i = 0;
    // align to 8 so the wide loop reads aligned words
    for (; i < n && (reinterpret_cast<uintptr_t>(buf + i) & 7); ++i)
        buf[i] ^= mask[i & 3];
    // the mask phase at offset i: rotate the replicated word to match
    uint64_t phase = i & 3;
    uint64_t m = wide;
    if (phase) {
        uint8_t rot[8];
        for (int k = 0; k < 8; ++k) rot[k] = rep[(k + phase) & 3];
        std::memcpy(&m, rot, 8);
    }
    for (; i + 8 <= n; i += 8) {
        uint64_t w;
        std::memcpy(&w, buf + i, 8);
        w ^= m;
        std::memcpy(buf + i, &w, 8);
    }
    for (; i < n; ++i) buf[i] ^= mask[i & 3];
}

// float32 -> bfloat16 with round-to-nearest-even (matches XLA/ml_dtypes).
// NaNs are quieted to 0x7fc0-style payloads by the +rounding carry being
// suppressed: standard trick — if NaN, emit the truncated bits with the
// quiet bit forced.
void pg_f32_to_bf16(const uint32_t *src, uint16_t *dst, uint64_t n) {
    for (uint64_t i = 0; i < n; ++i) {
        uint32_t x = src[i];
        uint32_t exp = x & 0x7f800000u;
        if (exp == 0x7f800000u && (x & 0x007fffffu)) {
            dst[i] = static_cast<uint16_t>((x >> 16) | 0x0040u);  // quiet NaN
        } else {
            uint32_t rounding = 0x7fffu + ((x >> 16) & 1u);
            dst[i] = static_cast<uint16_t>((x + rounding) >> 16);
        }
    }
}

// bfloat16 -> float32 (exact: left shift).
void pg_bf16_to_f32(const uint16_t *src, uint32_t *dst, uint64_t n) {
    for (uint64_t i = 0; i < n; ++i)
        dst[i] = static_cast<uint32_t>(src[i]) << 16;
}

// Weighted accumulate: acc[i] += w * src[i] with a float64 carry — the
// FL report-ingest fold. One pass, no temporaries (the Python-side numpy
// fold allocated a full f64 copy of every diff tensor per report).
void pg_accum_f32(double *acc, const float *src, double w, uint64_t n) {
    if (w == 1.0) {
        for (uint64_t i = 0; i < n; ++i) acc[i] += static_cast<double>(src[i]);
    } else {
        for (uint64_t i = 0; i < n; ++i)
            acc[i] += w * static_cast<double>(src[i]);
    }
}

// Same fold fused with the bf16 wire decode: bf16 bit patterns accumulate
// straight into the float64 carry — the report never materializes as f32.
void pg_accum_bf16(double *acc, const uint16_t *src, double w, uint64_t n) {
    if (w == 1.0) {
        for (uint64_t i = 0; i < n; ++i) {
            uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
            float f;
            std::memcpy(&f, &bits, 4);
            acc[i] += static_cast<double>(f);
        }
    } else {
        for (uint64_t i = 0; i < n; ++i) {
            uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
            float f;
            std::memcpy(&f, &bits, 4);
            acc[i] += w * static_cast<double>(f);
        }
    }
}

// Base64 decode (standard alphabet, '=' padding, no whitespace). Returns
// the decoded byte count, or -1 on any invalid character / bad padding.
// One table-driven pass — the FL report path decodes ~1.7 MB per report
// and CPython's binascii adds a str→bytes transcode on top.
static const int8_t B64_REV[256] = {
    // generated: -1 everywhere except A-Z a-z 0-9 + /
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,62,-1,-1,-1,63,
    52,53,54,55,56,57,58,59,60,61,-1,-1,-1,-1,-1,-1,
    -1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9,10,11,12,13,14,
    15,16,17,18,19,20,21,22,23,24,25,-1,-1,-1,-1,-1,
    -1,26,27,28,29,30,31,32,33,34,35,36,37,38,39,40,
    41,42,43,44,45,46,47,48,49,50,51,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
};

int64_t pg_b64_decode(const uint8_t *src, uint64_t n, uint8_t *dst) {
    if (n % 4 != 0) return -1;
    if (n == 0) return 0;
    uint64_t full = n;
    uint64_t pad = 0;
    if (src[n - 1] == '=') { pad++; }
    if (n >= 2 && src[n - 2] == '=') { pad++; }
    full = n - 4;  // decode all full quads except the (possibly padded) last
    uint8_t *out = dst;
    for (uint64_t i = 0; i < full; i += 4) {
        int8_t a = B64_REV[src[i]], b = B64_REV[src[i + 1]];
        int8_t c = B64_REV[src[i + 2]], d = B64_REV[src[i + 3]];
        if ((a | b | c | d) < 0) return -1;
        uint32_t v = (uint32_t(a) << 18) | (uint32_t(b) << 12) |
                     (uint32_t(c) << 6) | uint32_t(d);
        out[0] = uint8_t(v >> 16);
        out[1] = uint8_t(v >> 8);
        out[2] = uint8_t(v);
        out += 3;
    }
    // final quad with padding handling
    const uint8_t *t = src + full;
    int8_t a = B64_REV[t[0]], b = B64_REV[t[1]];
    if ((a | b) < 0) return -1;
    if (pad == 2) {
        if (t[2] != '=' || t[3] != '=') return -1;
        out[0] = uint8_t((uint32_t(a) << 2) | (uint32_t(b) >> 4));
        out += 1;
    } else if (pad == 1) {
        int8_t c = B64_REV[t[2]];
        if (c < 0 || t[3] != '=') return -1;
        uint32_t v = (uint32_t(a) << 10) | (uint32_t(b) << 4) | (uint32_t(c) >> 2);
        out[0] = uint8_t(v >> 8);
        out[1] = uint8_t(v);
        out += 2;
    } else {
        int8_t c = B64_REV[t[2]], d = B64_REV[t[3]];
        if ((c | d) < 0) return -1;
        uint32_t v = (uint32_t(a) << 18) | (uint32_t(b) << 12) |
                     (uint32_t(c) << 6) | uint32_t(d);
        out[0] = uint8_t(v >> 16);
        out[1] = uint8_t(v >> 8);
        out[2] = uint8_t(v);
        out += 3;
    }
    return int64_t(out - dst);
}

int pg_abi_version(void) { return 2; }

}  // extern "C"
