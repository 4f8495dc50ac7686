// Native PCM codec for the audio-file data loader.
//
// The reference's readers/writers convert PCM sample-by-sample in C++
// (/root/reference/AudioFile/IAudioFile.cpp readAudio loops, OAudioFile.cpp
// writeAudio); this library plays the same role for the JAX framework's host-side
// data loading: branch-free per-format conversion loops the compiler can
// vectorise, callable from Python via ctypes (see io/native_codec.py).
//
// Conventions match io/audio_file.py exactly:
//  - ints are left-justified to 32 bits then scaled by 2^-31 on decode
//  - encode scales by 2^(bits-1), rounds to nearest, clips to the int range
//  - WAVE 8-bit PCM is unsigned-offset (the wave_uint8 flag)
//
// Build: g++ -O3 -march=native -shared -fPIC -o libhisstools_codec.so hisstools_codec.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

namespace {

enum Format : int32_t {
    kInt8 = 0,
    kInt16 = 1,
    kInt24 = 2,
    kInt32 = 3,
    kFloat32 = 4,
    kFloat64 = 5,
};

constexpr double kScale31 = 1.0 / 2147483648.0;  // 2^-31

inline uint16_t swap16(uint16_t v) { return __builtin_bswap16(v); }
inline uint32_t swap32(uint32_t v) { return __builtin_bswap32(v); }
inline uint64_t swap64(uint64_t v) { return __builtin_bswap64(v); }

template <typename T>
inline double clip_round(double x, int bits) {
    const double scale = static_cast<double>(1LL << (bits - 1));
    const double lo = -scale;
    const double hi = scale - 1.0;
    // std::round = half away from zero, matching the reference's C round()
    // (OAudioFile.cpp:562-571); nearbyint would tie-to-even and encode exact
    // half-LSB samples 1 LSB low.
    double v = std::round(x * scale);
    return std::min(std::max(v, lo), hi);
}

}  // namespace

extern "C" {

// Decode n interleaved samples of the given format into normalised doubles.
// Returns 0 on success, -1 on unknown format.
int ht_decode_pcm(const uint8_t* raw, int64_t n, int32_t fmt,
                  int32_t little_endian, int32_t wave_uint8, double* out) {
    switch (fmt) {
        case kInt8: {
            if (wave_uint8) {
                for (int64_t i = 0; i < n; i++) {
                    int32_t v = (static_cast<int32_t>(raw[i]) - 128) << 24;
                    out[i] = v * kScale31;
                }
            } else {
                const int8_t* p = reinterpret_cast<const int8_t*>(raw);
                for (int64_t i = 0; i < n; i++)
                    out[i] = (static_cast<int32_t>(p[i]) << 24) * kScale31;
            }
            return 0;
        }
        case kInt16: {
            const uint16_t* p = reinterpret_cast<const uint16_t*>(raw);
            for (int64_t i = 0; i < n; i++) {
                uint16_t u = little_endian ? p[i] : swap16(p[i]);
                int32_t v = static_cast<int32_t>(static_cast<int16_t>(u)) << 16;
                out[i] = v * kScale31;
            }
            return 0;
        }
        case kInt24: {
            for (int64_t i = 0; i < n; i++) {
                const uint8_t* b = raw + i * 3;
                uint32_t u = little_endian
                    ? (static_cast<uint32_t>(b[0]) << 8) |
                      (static_cast<uint32_t>(b[1]) << 16) |
                      (static_cast<uint32_t>(b[2]) << 24)
                    : (static_cast<uint32_t>(b[2]) << 8) |
                      (static_cast<uint32_t>(b[1]) << 16) |
                      (static_cast<uint32_t>(b[0]) << 24);
                out[i] = static_cast<int32_t>(u) * kScale31;
            }
            return 0;
        }
        case kInt32: {
            const uint32_t* p = reinterpret_cast<const uint32_t*>(raw);
            for (int64_t i = 0; i < n; i++) {
                uint32_t u = little_endian ? p[i] : swap32(p[i]);
                out[i] = static_cast<int32_t>(u) * kScale31;
            }
            return 0;
        }
        case kFloat32: {
            const uint32_t* p = reinterpret_cast<const uint32_t*>(raw);
            for (int64_t i = 0; i < n; i++) {
                uint32_t u = little_endian ? p[i] : swap32(p[i]);
                float f;
                std::memcpy(&f, &u, 4);
                out[i] = static_cast<double>(f);
            }
            return 0;
        }
        case kFloat64: {
            const uint64_t* p = reinterpret_cast<const uint64_t*>(raw);
            for (int64_t i = 0; i < n; i++) {
                uint64_t u = little_endian ? p[i] : swap64(p[i]);
                double d;
                std::memcpy(&d, &u, 8);
                out[i] = d;
            }
            return 0;
        }
    }
    return -1;
}

// Encode n normalised doubles into interleaved PCM bytes.
int ht_encode_pcm(const double* in, int64_t n, int32_t fmt,
                  int32_t little_endian, int32_t wave_uint8, uint8_t* out) {
    switch (fmt) {
        case kInt8: {
            if (wave_uint8) {
                // Reference inputToU8 (OAudioFile.cpp:575-583): round AFTER
                // the +128 offset, then clip [0, 255].
                for (int64_t i = 0; i < n; i++) {
                    double v = std::round(in[i] * 128.0 + 128.0);
                    out[i] = static_cast<uint8_t>(
                        std::min(std::max(v, 0.0), 255.0));
                }
            } else {
                int8_t* p = reinterpret_cast<int8_t*>(out);
                for (int64_t i = 0; i < n; i++)
                    p[i] = static_cast<int8_t>(clip_round<int8_t>(in[i], 8));
            }
            return 0;
        }
        case kInt16: {
            uint16_t* p = reinterpret_cast<uint16_t*>(out);
            for (int64_t i = 0; i < n; i++) {
                uint16_t u = static_cast<uint16_t>(
                    static_cast<int16_t>(clip_round<int16_t>(in[i], 16)));
                p[i] = little_endian ? u : swap16(u);
            }
            return 0;
        }
        case kInt24: {
            for (int64_t i = 0; i < n; i++) {
                uint32_t u = static_cast<uint32_t>(
                    static_cast<int32_t>(clip_round<int32_t>(in[i], 24))) & 0xFFFFFF;
                uint8_t* b = out + i * 3;
                if (little_endian) {
                    b[0] = u & 0xFF; b[1] = (u >> 8) & 0xFF; b[2] = (u >> 16) & 0xFF;
                } else {
                    b[2] = u & 0xFF; b[1] = (u >> 8) & 0xFF; b[0] = (u >> 16) & 0xFF;
                }
            }
            return 0;
        }
        case kInt32: {
            uint32_t* p = reinterpret_cast<uint32_t*>(out);
            for (int64_t i = 0; i < n; i++) {
                uint32_t u = static_cast<uint32_t>(
                    static_cast<int32_t>(clip_round<int32_t>(in[i], 32)));
                p[i] = little_endian ? u : swap32(u);
            }
            return 0;
        }
        case kFloat32: {
            uint32_t* p = reinterpret_cast<uint32_t*>(out);
            for (int64_t i = 0; i < n; i++) {
                float f = static_cast<float>(in[i]);
                uint32_t u;
                std::memcpy(&u, &f, 4);
                p[i] = little_endian ? u : swap32(u);
            }
            return 0;
        }
        case kFloat64: {
            uint64_t* p = reinterpret_cast<uint64_t*>(out);
            for (int64_t i = 0; i < n; i++) {
                uint64_t u;
                std::memcpy(&u, &in[i], 8);
                p[i] = little_endian ? u : swap64(u);
            }
            return 0;
        }
    }
    return -1;
}

// Deinterleave one channel out of an interleaved normalised buffer.
void ht_extract_channel(const double* interleaved, int64_t frames,
                        int32_t channels, int32_t channel, double* out) {
    for (int64_t i = 0; i < frames; i++)
        out[i] = interleaved[i * channels + channel];
}

int32_t ht_codec_version() { return 1; }

}  // extern "C"
