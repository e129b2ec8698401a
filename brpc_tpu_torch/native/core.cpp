// brpc_tpu_torch native core — hot-path primitives behind ctypes.
//
// Counterpart of the reference's native base kit: crc32c (butil/crc32c.cc,
// hardware-accelerated with a software fallback), fast_rand
// (butil/fast_rand.cpp, wyrand-style), and a batched TRPC frame scanner
// (the inner loop of InputMessenger::CutInputMessage, input_messenger.cpp:84,
// done natively so pipelined traffic cuts N frames per interpreter call).
//
// Build: g++ -O3 -shared -fPIC (see brpc_tpu_torch/native/__init__.py);
// exposes a plain C ABI so ctypes needs no binding generator.

#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

extern "C" {

// ------------------------------------------------------------------ crc32c
static uint32_t g_crc_table[8][256];
static bool g_crc_init = false;

static void crc32c_init_table() {
    const uint32_t POLY = 0x82F63B78u;
    for (int i = 0; i < 256; ++i) {
        uint32_t crc = (uint32_t)i;
        for (int j = 0; j < 8; ++j)
            crc = (crc & 1) ? (crc >> 1) ^ POLY : crc >> 1;
        g_crc_table[0][i] = crc;
    }
    for (int i = 0; i < 256; ++i) {
        uint32_t crc = g_crc_table[0][i];
        for (int k = 1; k < 8; ++k) {
            crc = g_crc_table[0][crc & 0xFF] ^ (crc >> 8);
            g_crc_table[k][i] = crc;
        }
    }
    g_crc_init = true;
}

uint32_t tn_crc32c(const uint8_t* data, uint64_t len, uint32_t value) {
    uint32_t crc = value ^ 0xFFFFFFFFu;
#if defined(__SSE4_2__)
    while (len >= 8) {
        uint64_t chunk;
        memcpy(&chunk, data, 8);
        crc = (uint32_t)_mm_crc32_u64((uint64_t)crc, chunk);
        data += 8;
        len -= 8;
    }
    while (len--) crc = _mm_crc32_u8(crc, *data++);
#else
    if (!g_crc_init) crc32c_init_table();
    // slicing-by-8
    while (len >= 8) {
        uint64_t chunk;
        memcpy(&chunk, data, 8);
        crc ^= (uint32_t)chunk;
        uint32_t hi = (uint32_t)(chunk >> 32);
        crc = g_crc_table[7][crc & 0xFF] ^ g_crc_table[6][(crc >> 8) & 0xFF] ^
              g_crc_table[5][(crc >> 16) & 0xFF] ^ g_crc_table[4][crc >> 24] ^
              g_crc_table[3][hi & 0xFF] ^ g_crc_table[2][(hi >> 8) & 0xFF] ^
              g_crc_table[1][(hi >> 16) & 0xFF] ^ g_crc_table[0][hi >> 24];
        data += 8;
        len -= 8;
    }
    while (len--)
        crc = g_crc_table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
#endif
    return crc ^ 0xFFFFFFFFu;
}

// --------------------------------------------------------------- fast_rand
// wyrand-style: one 64-bit state word, multiply-xorshift output.
uint64_t tn_fast_rand(uint64_t* state) {
    *state += 0xa0761d6478bd642full;
    __uint128_t t = (__uint128_t)(*state ^ 0xe7037ed1a0b428dbull) * (*state);
    return (uint64_t)(t >> 64) ^ (uint64_t)t;
}

uint64_t tn_fast_rand_less_than(uint64_t* state, uint64_t bound) {
    if (bound == 0) return 0;
    // Lemire's multiply-shift bounded rand (no modulo bias worth caring
    // about at these ranges; the reference's fast_rand is similarly loose)
    __uint128_t m = (__uint128_t)tn_fast_rand(state) * bound;
    return (uint64_t)(m >> 64);
}

// ------------------------------------------------------------ frame scanner
// Scan consecutive complete "TRPC"/"TSTR" frames in a contiguous buffer.
// Writes for each complete frame: offsets[i*3] = frame start,
// offsets[i*3+1] = meta_size, offsets[i*3+2] = body_size. Returns the
// number of complete frames (<= max_frames); *consumed = bytes covered by
// them. Returns -1 on a malformed header (bad magic at a frame boundary or
// size > max_body), with *consumed = bytes up to the bad frame.
int tn_frame_scan(const uint8_t* buf, uint64_t len, uint64_t max_body,
                  uint64_t* offsets, int max_frames, uint64_t* consumed) {
    uint64_t pos = 0;
    int n = 0;
    while (n < max_frames && len - pos >= 12) {
        const uint8_t* h = buf + pos;
        bool trpc = (h[0] == 'T' && h[1] == 'R' && h[2] == 'P' && h[3] == 'C');
        bool tstr = (h[0] == 'T' && h[1] == 'S' && h[2] == 'T' && h[3] == 'R');
        if (!trpc && !tstr) {
            *consumed = pos;
            return -1;
        }
        uint32_t meta_size = ((uint32_t)h[4] << 24) | ((uint32_t)h[5] << 16) |
                             ((uint32_t)h[6] << 8) | (uint32_t)h[7];
        uint32_t body_size = ((uint32_t)h[8] << 24) | ((uint32_t)h[9] << 16) |
                             ((uint32_t)h[10] << 8) | (uint32_t)h[11];
        if ((uint64_t)meta_size + body_size > max_body) {
            *consumed = pos;
            return -1;
        }
        uint64_t total = 12ull + meta_size + body_size;
        if (len - pos < total) break;  // incomplete tail frame
        offsets[n * 3] = pos;
        offsets[n * 3 + 1] = meta_size;
        offsets[n * 3 + 2] = body_size;
        pos += total;
        ++n;
    }
    *consumed = pos;
    return n;
}

// ------------------------------------------------------------------- probe
int tn_abi_version() { return 1; }

}  // extern "C"
