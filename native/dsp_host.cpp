// dsp_host: native host-side runtime for dsp_stuff_tpu.
//
// The host-side analog of the reference's device layer
// (/root/reference/dsp-stuff/src/devices.rs): WAV decode/encode with
// sample-format conversion (devices.rs:264-352 converts i8..f64 <-> f32),
// a 16-tap windowed-sinc resampler (the output path resamples 48 kHz ->
// device rate with a sinc-16 interpolator, devices.rs:550-556), the
// capture-path channel fold (stereo summed to mono, devices.rs:254), and a
// lock-free SPSC ring buffer (the rivulet analog) for streaming feeds.
//
// Pure C ABI; loaded from Python via ctypes (dsp_stuff_tpu/io/native.py).
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>

extern "C" {

void dsp_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// WAV I/O
// ---------------------------------------------------------------------------

namespace {

struct Reader {
    const uint8_t* p;
    size_t n;
    size_t off = 0;
    bool read(void* dst, size_t k) {
        if (off + k > n) return false;
        std::memcpy(dst, p + off, k);
        off += k;
        return true;
    }
    bool skip(size_t k) {
        if (off + k > n) return false;
        off += k;
        return true;
    }
};

inline float u8_to_f32(uint8_t v) { return ((float)v - 128.0f) / 128.0f; }
inline float i16_to_f32(int16_t v) { return (float)v / 32768.0f; }
inline float i32_to_f32(int32_t v) { return (float)((double)v / 2147483648.0); }

uint8_t* read_file(const char* path, size_t* out_n) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (n < 0) { std::fclose(f); return nullptr; }
    uint8_t* buf = (uint8_t*)std::malloc((size_t)n);
    if (!buf) { std::fclose(f); return nullptr; }
    size_t got = std::fread(buf, 1, (size_t)n, f);
    std::fclose(f);
    if (got != (size_t)n) { std::free(buf); return nullptr; }
    *out_n = (size_t)n;
    return buf;
}

}  // namespace

// Decode a RIFF/WAVE file into planar f32 [ch][frames].
// Returns 0 on success; *out_data is malloc'd (ch*frames floats), caller
// frees with dsp_free.  Supports PCM 8/16/24/32 and IEEE float32/64
// (same matrix as io/wav.py and devices.rs:309-345).
int dsp_wav_read(const char* path, float** out_data, int32_t* n_ch,
                 int64_t* n_frames, int32_t* rate) {
    size_t total = 0;
    uint8_t* buf = read_file(path, &total);
    if (!buf) return -1;
    Reader r{buf, total};

    char riff[12];
    if (!r.read(riff, 12) || std::memcmp(riff, "RIFF", 4) ||
        std::memcmp(riff + 8, "WAVE", 4)) {
        std::free(buf);
        return -2;
    }
    uint16_t tag = 0, ch = 0, bits = 0;
    uint32_t sr = 0;
    const uint8_t* data = nullptr;
    uint32_t data_len = 0;
    while (r.off + 8 <= r.n) {
        char cid[4];
        uint32_t sz = 0;
        r.read(cid, 4);
        r.read(&sz, 4);
        size_t start = r.off;
        if (!std::memcmp(cid, "fmt ", 4) && sz >= 16) {
            uint16_t block_align;
            uint32_t brate;
            r.read(&tag, 2);
            r.read(&ch, 2);
            r.read(&sr, 4);
            r.read(&brate, 4);
            r.read(&block_align, 2);
            r.read(&bits, 2);
            if (tag == 0xFFFE && sz >= 40) {           // EXTENSIBLE
                r.skip(8);                              // cbSize + valid bits + mask(2 of 4)
                uint16_t sub;
                r.read(&sub, 2);
                tag = sub;
            }
        } else if (!std::memcmp(cid, "data", 4)) {
            data = r.p + r.off;
            // a declared size past EOF must not leak reads beyond the file
            // buffer: clamp to the bytes actually present
            data_len = (uint32_t)std::min<size_t>(sz, r.n - r.off);
        }
        r.off = start + sz + (sz & 1);
        if (r.off > r.n) break;
    }
    // reject absent/garbage fmt before the frames division: bits must be a
    // positive multiple of 8 (bits==0 would divide by zero below)
    if (!tag || !ch || !data || bits == 0 || (bits % 8) != 0) {
        std::free(buf);
        return -3;
    }

    size_t bytes_per = bits / 8;
    int64_t frames = (int64_t)(data_len / (bytes_per * ch));
    float* out = (float*)std::malloc(sizeof(float) * (size_t)frames * ch);
    if (!out) { std::free(buf); return -4; }

    for (int64_t t = 0; t < frames; ++t) {
        for (int c = 0; c < (int)ch; ++c) {
            const uint8_t* s = data + (size_t)(t * ch + c) * bytes_per;
            float v = 0.0f;
            if (tag == 3 && bits == 32) {
                float f;
                std::memcpy(&f, s, 4);
                v = f;
            } else if (tag == 3 && bits == 64) {
                double d;
                std::memcpy(&d, s, 8);
                v = (float)d;
            } else if (tag == 1 && bits == 8) {
                v = u8_to_f32(*s);
            } else if (tag == 1 && bits == 16) {
                int16_t i;
                std::memcpy(&i, s, 2);
                v = i16_to_f32(i);
            } else if (tag == 1 && bits == 24) {
                int32_t i = (int32_t)s[0] | ((int32_t)s[1] << 8) |
                            ((int32_t)s[2] << 16);
                if (i & 0x800000) i -= (1 << 24);
                v = (float)i / 8388608.0f;
            } else if (tag == 1 && bits == 32) {
                int32_t i;
                std::memcpy(&i, s, 4);
                v = i32_to_f32(i);
            } else {
                std::free(buf);
                std::free(out);
                return -5;  // unsupported format (devices.rs:346-351 parity)
            }
            out[(size_t)c * frames + t] = v;            // planar
        }
    }
    std::free(buf);
    *out_data = out;
    *n_ch = ch;
    *n_frames = frames;
    *rate = (int32_t)sr;
    return 0;
}

// Encode planar f32 [ch][frames] to a WAV file; float_fmt != 0 -> IEEE
// float32, else PCM16 (clipped).  Returns 0 on success.
int dsp_wav_write(const char* path, const float* data, int32_t n_ch,
                  int64_t n_frames, int32_t rate, int32_t float_fmt) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    uint16_t tag = float_fmt ? 3 : 1;
    uint16_t bits = float_fmt ? 32 : 16;
    uint32_t payload = (uint32_t)(n_frames * n_ch * (bits / 8));
    uint32_t brate = (uint32_t)rate * n_ch * (bits / 8);
    uint16_t align = (uint16_t)(n_ch * (bits / 8));
    uint32_t riff_len = 4 + 8 + 16 + 8 + payload;

    std::fwrite("RIFF", 1, 4, f);
    std::fwrite(&riff_len, 4, 1, f);
    std::fwrite("WAVE", 1, 4, f);
    std::fwrite("fmt ", 1, 4, f);
    uint32_t fmt_len = 16;
    std::fwrite(&fmt_len, 4, 1, f);
    uint16_t ch16 = (uint16_t)n_ch;
    uint32_t r32 = (uint32_t)rate;
    std::fwrite(&tag, 2, 1, f);
    std::fwrite(&ch16, 2, 1, f);
    std::fwrite(&r32, 4, 1, f);
    std::fwrite(&brate, 4, 1, f);
    std::fwrite(&align, 2, 1, f);
    std::fwrite(&bits, 2, 1, f);
    std::fwrite("data", 1, 4, f);
    std::fwrite(&payload, 4, 1, f);
    for (int64_t t = 0; t < n_frames; ++t) {
        for (int c = 0; c < n_ch; ++c) {
            float v = data[(size_t)c * n_frames + t];
            if (float_fmt) {
                std::fwrite(&v, 4, 1, f);
            } else {
                float cl = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
                int16_t i = (int16_t)lrintf(cl * 32767.0f);
                std::fwrite(&i, 2, 1, f);
            }
        }
    }
    std::fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// Sinc-16 resampler (output-path analog of devices.rs:550-556)
// ---------------------------------------------------------------------------

// Windowed-sinc interpolation with 16 taps (8 each side), Hann window.
// ratio = out_rate / in_rate.  Returns number of output frames; *out is
// malloc'd, freed by caller with dsp_free.
int64_t dsp_resample_sinc16(const float* in, int64_t n_in, double ratio,
                            float** out) {
    if (n_in <= 0 || ratio <= 0) return -1;
    const int HALF = 8;
    int64_t n_out = (int64_t)std::floor((double)n_in * ratio);
    float* o = (float*)std::malloc(sizeof(float) * (size_t)n_out);
    if (!o) return -1;
    const double PI = 3.14159265358979323846;
    // anti-aliasing cutoff when downsampling
    const double fc = ratio < 1.0 ? ratio : 1.0;
    for (int64_t k = 0; k < n_out; ++k) {
        double t = (double)k / ratio;          // position in input samples
        int64_t i0 = (int64_t)std::floor(t);
        double frac = t - (double)i0;
        double acc = 0.0;
        for (int m = -HALF + 1; m <= HALF; ++m) {
            int64_t idx = i0 + m;
            double x = ((double)m - frac);
            double sinc = (std::fabs(x) < 1e-12)
                              ? 1.0
                              : std::sin(PI * fc * x) / (PI * fc * x);
            // Hann window over the 16-tap span
            double w = 0.5 * (1.0 + std::cos(PI * x / HALF));
            if (x < -HALF || x > HALF) w = 0.0;
            double s = (idx < 0 || idx >= n_in) ? 0.0 : (double)in[idx];
            acc += fc * sinc * w * s;
        }
        o[k] = (float)acc;
    }
    *out = o;
    return n_out;
}

// ---------------------------------------------------------------------------
// Capture-path channel fold (devices.rs:248-262: stereo SUMMED to mono)
// ---------------------------------------------------------------------------

void dsp_sum_stereo(const float* l, const float* r, float* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = l[i] + r[i];
}

// interleaved stereo -> summed mono (the do_read_2 inner loop shape)
void dsp_fold_interleaved_stereo(const float* in, float* out, int64_t frames) {
    for (int64_t i = 0; i < frames; ++i) out[i] = in[2 * i] + in[2 * i + 1];
}

// mono -> duplicated interleaved stereo (devices.rs:476-480)
void dsp_dup_to_stereo(const float* in, float* out, int64_t frames) {
    for (int64_t i = 0; i < frames; ++i) {
        out[2 * i] = in[i];
        out[2 * i + 1] = in[i];
    }
}

// ---------------------------------------------------------------------------
// Lock-free SPSC ring buffer (the rivulet analog; links are 8192 f32 in the
// reference, runtime.rs:568)
// ---------------------------------------------------------------------------

struct DspRing {
    float* buf;
    int64_t cap;
    std::atomic<int64_t> head{0};  // write position (producer)
    std::atomic<int64_t> tail{0};  // read position (consumer)
};

void* dsp_ring_new(int64_t capacity) {
    auto* r = new (std::nothrow) DspRing;
    if (!r) return nullptr;
    r->buf = (float*)std::calloc((size_t)capacity + 1, sizeof(float));
    if (!r->buf) {
        delete r;
        return nullptr;
    }
    r->cap = capacity + 1;  // one slot kept empty to distinguish full/empty
    return r;
}

void dsp_ring_free(void* h) {
    auto* r = (DspRing*)h;
    if (!r) return;
    std::free(r->buf);
    delete r;
}

int64_t dsp_ring_readable(void* h) {
    auto* r = (DspRing*)h;
    int64_t head = r->head.load(std::memory_order_acquire);
    int64_t tail = r->tail.load(std::memory_order_acquire);
    return (head - tail + r->cap) % r->cap;
}

int64_t dsp_ring_writable(void* h) {
    auto* r = (DspRing*)h;
    return r->cap - 1 - dsp_ring_readable(h);
}

// returns frames actually written (drops the rest -- input-overrun behavior,
// devices.rs:239-241 drops the incoming block when the pipe is full)
int64_t dsp_ring_write(void* h, const float* src, int64_t n) {
    auto* r = (DspRing*)h;
    int64_t can = dsp_ring_writable(h);
    int64_t k = n < can ? n : can;
    int64_t head = r->head.load(std::memory_order_relaxed);
    for (int64_t i = 0; i < k; ++i) r->buf[(head + i) % r->cap] = src[i];
    r->head.store((head + k) % r->cap, std::memory_order_release);
    return k;
}

// returns frames actually read; short reads leave dst's tail untouched
// (underrun handling -- zero-fill -- is the caller's policy, matching
// devices.rs:436-440)
int64_t dsp_ring_read(void* h, float* dst, int64_t n) {
    auto* r = (DspRing*)h;
    int64_t can = dsp_ring_readable(h);
    int64_t k = n < can ? n : can;
    int64_t tail = r->tail.load(std::memory_order_relaxed);
    for (int64_t i = 0; i < k; ++i) dst[i] = r->buf[(tail + i) % r->cap];
    r->tail.store((tail + k) % r->cap, std::memory_order_release);
    return k;
}

// drop all buffered samples (the resync drain, runtime.rs:587-594)
void dsp_ring_drain(void* h) {
    auto* r = (DspRing*)h;
    r->tail.store(r->head.load(std::memory_order_acquire),
                  std::memory_order_release);
}

}  // extern "C"
