// qwen3tts_native — the port's host library: GGUF weight-file parsing and
// dequantization, WAV encoding and linear resampling, behind a plain C ABI
// for ctypes (qwen3tts_tpu_torch/io/native.py). A copy of the JAX package's
// qwen3tts_tpu/native/qwen3tts_native.cpp with the same entry points and
// arithmetic, plus gguf_last_error(): every failure of gguf_open and of the
// tensor reads leaves a message there. Half-precision values are widened
// through a table of the same conversion (fp16_table: the same bits, and a
// Q8_0 file, most of whose elements are its F16 text embedding, reads in
// about half the time), into buffers the read does not zero first.
//
// Build (io/native.py does it at first use, into qwen3tts_tpu_torch/_build/):
//   g++ -O3 -std=c++17 -fPIC -ffp-contract=off -shared qwen3tts_native.cpp -o lib.so
// -ffp-contract=off keeps Q4_K's `scale * q - min` two roundings, as numpy
// computes it, on a host whose -march would fuse it.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>
#include <memory>

namespace {

constexpr uint32_t kGgufMagic = 0x46554747;  // "GGUF"
constexpr int kQ8Block = 32;
constexpr int kQ8BlockBytes = 34;

enum GgmlType : uint32_t { GGML_F32 = 0, GGML_F16 = 1, GGML_Q8_0 = 8,
                           GGML_Q4_K = 12 };

constexpr int kQKK = 256;            // Q4_K super-block values
constexpr int kQ4KBlockBytes = 144;  // f16 d + f16 dmin + 12 scales + 128 qs

// ggml get_scale_min_k4: unpack 6-bit (scale, min) pair j from 12 bytes.
inline void q4k_scale_min(const uint8_t* s, int j, uint8_t* sc, uint8_t* m) {
    if (j < 4) {
        *sc = s[j] & 63;
        *m = s[j + 4] & 63;
    } else {
        *sc = (uint8_t)((s[j + 4] & 0xF) | ((s[j - 4] >> 6) << 4));
        *m = (uint8_t)((s[j + 4] >> 4) | ((s[j] >> 6) << 4));
    }
}

float fp16_to_fp32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1Fu;
    uint32_t mant = h & 0x3FFu;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {  // subnormal
            int shift = 0;
            while (!(mant & 0x400u)) { mant <<= 1; ++shift; }
            mant &= 0x3FFu;
            bits = sign | ((127 - 15 - shift + 1) << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (mant << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

struct TensorInfo {
    std::string name;
    std::vector<uint64_t> shape;  // numpy order (reversed ne)
    uint32_t type = 0;
    uint64_t offset = 0;          // relative to data section
    uint64_t n_elements = 1;
};

struct GgufFile {
    FILE* f = nullptr;
    std::vector<TensorInfo> tensors;
    uint64_t data_start = 0;
    std::string error;

    ~GgufFile() { if (f) fclose(f); }
};

thread_local std::string g_error;

// Record a failure for gguf_last_error(); returns `ret` for one-line use.
template <typename T>
T fail(T ret, const std::string& msg) {
    g_error = msg;
    return ret;
}

bool read_exact(FILE* f, void* dst, size_t n) {
    return fread(dst, 1, n, f) == n;
}

template <typename T>
bool read_pod(FILE* f, T* v) { return read_exact(f, v, sizeof(T)); }

bool read_string(FILE* f, std::string* out) {
    uint64_t n;
    if (!read_pod(f, &n) || n > (1ull << 31)) return false;
    out->resize(n);
    return n == 0 || read_exact(f, &(*out)[0], n);
}

// skip a metadata value of the given type (we only need tensor data natively;
// metadata parsing stays in Python where it is not hot)
bool skip_value(FILE* f, uint32_t type, uint64_t* alignment) {
    static const int sizes[] = {1, 1, 2, 2, 4, 4, 4, 1, -1, -2, 8, 8, 8};
    if (type == 8) {  // string
        std::string s;
        return read_string(f, &s);
    }
    if (type == 9) {  // array
        uint32_t et;
        uint64_t n;
        if (!read_pod(f, &et) || !read_pod(f, &n)) return false;
        for (uint64_t i = 0; i < n; ++i) {
            if (!skip_value(f, et, alignment)) return false;
        }
        return true;
    }
    if (type > 12) return false;
    int sz = sizes[type];
    if (type == 4 && alignment) {
        // caller patches alignment for "general.alignment" keys before skip
    }
    return fseek(f, sz, SEEK_CUR) == 0;
}

// Every half-precision value widened once (fp16_to_fp32 of each of the
// 65536 bit patterns): a table lookup gives the same bits as the branchy
// conversion at a fraction of its cost (the F16 text embedding is most of
// a Q8_0 file's elements).
const float* fp16_table() {
    static const std::vector<float> table = [] {
        std::vector<float> t(65536);
        for (uint32_t h = 0; h < 65536; ++h) t[h] = fp16_to_fp32((uint16_t)h);
        return t;
    }();
    return table.data();
}

// The tensor's stored bytes, uninitialised before the read.
bool read_raw(GgufFile* gf, uint64_t nbytes, std::unique_ptr<uint8_t[]>* buf) {
    buf->reset(new uint8_t[nbytes]);
    return read_exact(gf->f, buf->get(), nbytes);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// GGUF
// ---------------------------------------------------------------------------

const char* gguf_last_error() { return g_error.c_str(); }

void* gguf_open(const char* path) {
    g_error.clear();
    auto gf = std::make_unique<GgufFile>();
    gf->f = fopen(path, "rb");
    if (!gf->f) return fail<void*>(nullptr, std::string("cannot open ") + path);
    FILE* f = gf->f;

    uint32_t magic = 0, version = 0;
    uint64_t n_tensors = 0, n_kv = 0;
    if (!read_pod(f, &magic) || magic != kGgufMagic)
        return fail<void*>(nullptr, "bad GGUF magic");
    if (!read_pod(f, &version) || version < 2)
        return fail<void*>(nullptr, "unsupported GGUF version " + std::to_string(version));
    if (!read_pod(f, &n_tensors) || !read_pod(f, &n_kv))
        return fail<void*>(nullptr, "truncated GGUF header");

    uint64_t alignment = 32;
    for (uint64_t i = 0; i < n_kv; ++i) {
        std::string key;
        uint32_t type;
        if (!read_string(f, &key) || !read_pod(f, &type))
            return fail<void*>(nullptr, "truncated metadata key " + std::to_string(i));
        if (key == "general.alignment" && type == 4) {
            uint32_t a;
            if (!read_pod(f, &a) || a == 0)
                return fail<void*>(nullptr, "bad general.alignment");
            alignment = a;
            continue;
        }
        if (!skip_value(f, type, &alignment))
            return fail<void*>(nullptr, "bad metadata value of " + key + " (type " +
                                            std::to_string(type) + ")");
    }

    gf->tensors.resize(n_tensors);
    for (uint64_t i = 0; i < n_tensors; ++i) {
        TensorInfo& t = gf->tensors[i];
        uint32_t n_dims;
        const std::string where = "tensor " + std::to_string(i);
        if (!read_string(f, &t.name) || !read_pod(f, &n_dims))
            return fail<void*>(nullptr, "truncated tensor table at " + where);
        if (n_dims > 8)
            return fail<void*>(nullptr, t.name + ": " + std::to_string(n_dims) + " dims > 8");
        std::vector<uint64_t> ne(n_dims);
        for (uint32_t d = 0; d < n_dims; ++d) {
            if (!read_pod(f, &ne[d])) return fail<void*>(nullptr, "truncated shape of " + t.name);
            t.n_elements *= ne[d];
        }
        t.shape.assign(ne.rbegin(), ne.rend());
        if (!read_pod(f, &t.type) || !read_pod(f, &t.offset))
            return fail<void*>(nullptr, "truncated type/offset of " + t.name);
    }
    long pos = ftell(f);
    gf->data_start = (uint64_t)((pos + alignment - 1) / alignment * alignment);
    return gf.release();
}

void gguf_close(void* handle) { delete static_cast<GgufFile*>(handle); }

int64_t gguf_n_tensors(void* handle) {
    return (int64_t)static_cast<GgufFile*>(handle)->tensors.size();
}

const char* gguf_tensor_name(void* handle, int64_t i) {
    auto* gf = static_cast<GgufFile*>(handle);
    if (i < 0 || (size_t)i >= gf->tensors.size()) return nullptr;
    return gf->tensors[i].name.c_str();
}

// shape_out must hold 8 entries; returns n_dims, fills type/n_elements.
int32_t gguf_tensor_info(void* handle, int64_t i, int64_t* shape_out,
                         int32_t* type_out, int64_t* n_elements_out) {
    auto* gf = static_cast<GgufFile*>(handle);
    if (i < 0 || (size_t)i >= gf->tensors.size()) return -1;
    const TensorInfo& t = gf->tensors[i];
    for (size_t d = 0; d < t.shape.size(); ++d) shape_out[d] = (int64_t)t.shape[d];
    *type_out = (int32_t)t.type;
    *n_elements_out = (int64_t)t.n_elements;
    return (int32_t)t.shape.size();
}

// Read + convert to f32 (fseek/fread like gguf_loader.cpp:154-227, then
// F16->F32 / Q8_0 / Q4_K dequantization; each value as the JAX package's
// library computes it, the half-precision ones through fp16_table).
int32_t gguf_read_tensor_f32(void* handle, int64_t i, float* out) {
    auto* gf = static_cast<GgufFile*>(handle);
    if (i < 0 || (size_t)i >= gf->tensors.size()) return fail(-1, "tensor index out of range");
    const TensorInfo& t = gf->tensors[i];
    if (fseek(gf->f, (long)(gf->data_start + t.offset), SEEK_SET) != 0)
        return fail(-2, "cannot seek to " + t.name);
    const std::string truncated = "truncated data of " + t.name;

    const uint64_t n = t.n_elements;
    std::unique_ptr<uint8_t[]> buf;
    if (t.type == GGML_F32) {
        return read_exact(gf->f, out, n * 4) ? 0 : fail(-3, truncated);
    }
    if (t.type == GGML_F16) {
        if (!read_raw(gf, n * 2, &buf)) return fail(-3, truncated);
        const uint16_t* h = reinterpret_cast<const uint16_t*>(buf.get());
        const float* tab = fp16_table();
        for (uint64_t k = 0; k < n; ++k) out[k] = tab[h[k]];
        return 0;
    }
    if (t.type == GGML_Q8_0) {
        const uint64_t n_blocks = n / kQ8Block;
        if (!read_raw(gf, n_blocks * kQ8BlockBytes, &buf)) return fail(-3, truncated);
        const float* tab = fp16_table();
        const uint8_t* raw = buf.get();
        for (uint64_t b = 0; b < n_blocks; ++b) {
            const uint8_t* blk = raw + b * kQ8BlockBytes;
            uint16_t dh;
            std::memcpy(&dh, blk, 2);
            const float d = tab[dh];
            const int8_t* q = (const int8_t*)(blk + 2);
            float* dst = out + b * kQ8Block;
            for (int k = 0; k < kQ8Block; ++k) dst[k] = d * (float)q[k];
        }
        return 0;
    }
    if (t.type == GGML_Q4_K) {
        const uint64_t n_blocks = n / kQKK;
        if (!read_raw(gf, n_blocks * kQ4KBlockBytes, &buf)) return fail(-3, truncated);
        const float* tab = fp16_table();
        const uint8_t* raw = buf.get();
        for (uint64_t b = 0; b < n_blocks; ++b) {
            const uint8_t* blk = raw + b * kQ4KBlockBytes;
            uint16_t dh, dminh;
            std::memcpy(&dh, blk, 2);
            std::memcpy(&dminh, blk + 2, 2);
            const float d = tab[dh];
            const float dmin = tab[dminh];
            const uint8_t* scales = blk + 4;
            const uint8_t* qs = blk + 16;
            float* dst = out + b * kQKK;
            // 4 chunks of 64 values: low nibbles then high nibbles,
            // with separate 6-bit (scale, min) per 32-value sub-block
            for (int c = 0; c < 4; ++c) {
                uint8_t sc0, m0, sc1, m1;
                q4k_scale_min(scales, 2 * c, &sc0, &m0);
                q4k_scale_min(scales, 2 * c + 1, &sc1, &m1);
                const float s_lo = d * sc0, mn_lo = dmin * m0;
                const float s_hi = d * sc1, mn_hi = dmin * m1;
                const uint8_t* q = qs + 32 * c;
                for (int k = 0; k < 32; ++k) {
                    dst[64 * c + k] = s_lo * (float)(q[k] & 0xF) - mn_lo;
                    dst[64 * c + 32 + k] = s_hi * (float)(q[k] >> 4) - mn_hi;
                }
            }
        }
        return 0;
    }
    return fail(-4, t.name + ": unsupported tensor type " + std::to_string(t.type));
}

// Raw Q8_0 read: int8 values + f32 scales (feeds the int8 TPU matmul path).
int32_t gguf_read_tensor_q8(void* handle, int64_t i, int8_t* q_out, float* d_out) {
    auto* gf = static_cast<GgufFile*>(handle);
    if (i < 0 || (size_t)i >= gf->tensors.size()) return fail(-1, "tensor index out of range");
    const TensorInfo& t = gf->tensors[i];
    if (t.type != GGML_Q8_0) return fail(-4, t.name + " is not Q8_0");
    if (fseek(gf->f, (long)(gf->data_start + t.offset), SEEK_SET) != 0)
        return fail(-2, "cannot seek to " + t.name);
    const uint64_t n_blocks = t.n_elements / kQ8Block;
    std::vector<uint8_t> buf(n_blocks * kQ8BlockBytes);
    if (!read_exact(gf->f, buf.data(), buf.size())) return fail(-3, "truncated data of " + t.name);
    for (uint64_t b = 0; b < n_blocks; ++b) {
        const uint8_t* blk = buf.data() + b * kQ8BlockBytes;
        uint16_t dh;
        std::memcpy(&dh, blk, 2);
        d_out[b] = fp16_to_fp32(dh);
        std::memcpy(q_out + b * kQ8Block, blk + 2, kQ8Block);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// WAV (PCM16 encode — the hot path when writing long syntheses)
// ---------------------------------------------------------------------------

int32_t wav_write_pcm16(const char* path, const float* samples, int64_t n,
                        int32_t sample_rate) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    const uint32_t data_size = (uint32_t)(n * 2);
    const uint32_t file_size = 36 + data_size;
    const uint16_t one = 1, channels = 1, bits = 16, block = 2;
    const uint32_t byte_rate = (uint32_t)sample_rate * 2;
    const uint32_t fmt_size = 16;
    fwrite("RIFF", 1, 4, f); fwrite(&file_size, 4, 1, f); fwrite("WAVE", 1, 4, f);
    fwrite("fmt ", 1, 4, f); fwrite(&fmt_size, 4, 1, f);
    fwrite(&one, 2, 1, f); fwrite(&channels, 2, 1, f);
    fwrite(&sample_rate, 4, 1, f); fwrite(&byte_rate, 4, 1, f);
    fwrite(&block, 2, 1, f); fwrite(&bits, 2, 1, f);
    fwrite("data", 1, 4, f); fwrite(&data_size, 4, 1, f);
    std::vector<int16_t> pcm(n);
    for (int64_t i = 0; i < n; ++i) {
        float s = samples[i];
        if (s > 1.0f) s = 1.0f;
        if (s < -1.0f) s = -1.0f;
        pcm[i] = (int16_t)(s * 32767.0f);
    }
    fwrite(pcm.data(), 2, (size_t)n, f);
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// linear resampler (qwen3_tts.cpp:84-102 semantics)
// ---------------------------------------------------------------------------

int64_t resample_linear_len(int64_t n_in, int32_t in_rate, int32_t out_rate) {
    return (int64_t)((double)n_in / ((double)in_rate / out_rate));
}

void resample_linear(const float* in, int64_t n_in, int32_t in_rate,
                     float* out, int64_t n_out, int32_t out_rate) {
    const double ratio = (double)in_rate / out_rate;
    for (int64_t i = 0; i < n_out; ++i) {
        const double src = i * ratio;
        const int64_t i0 = (int64_t)src;
        const int64_t i1 = i0 + 1;
        const double frac = src - (double)i0;
        out[i] = (i1 >= n_in) ? in[n_in - 1]
                              : (float)((1.0 - frac) * in[i0] + frac * in[i1]);
    }
}

}  // extern "C"
