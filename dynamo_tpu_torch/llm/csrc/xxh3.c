/* XXH3-64 (xxHash 0.8 family, Yann Collet's published algorithm), written
 * out for the port's block hashes: the reference hashes blocks with
 * xxhash.xxh3_64_intdigest(data, seed=1337), and the card's machine has no
 * xxhash package. Every length path of the algorithm is here (0, 1-3, 4-8,
 * 9-16, 17-128, 129-240, and the striped long path past 240 with the custom
 * secret a nonzero seed derives), scalar and portable; the host must be
 * little-endian (the tokens are hashed as their little-endian u32 bytes,
 * which is then their memory).
 *
 * Entry points (plain C, loaded with ctypes by llm/_xxh3.py):
 *   xxh3_64(data, len, seed)                 one hash
 *   xxh3_token_blocks(tokens, n_blocks, block_size, salt, seed, parent,
 *                     has_parent, block_hashes, seq_hashes)
 *       the block hash of each of n_blocks full blocks of u32 tokens (the
 *       8-byte little-endian salt prefixed to the first block's bytes when
 *       salt != 0 and there is no parent) and its chained sequence hash:
 *       the first block's is its block hash when there is no parent, every
 *       other's hashes the 16 bytes (parent, block) as two little-endian u64.
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "xxh3.c assumes a little-endian host"
#endif

#define P32_1 0x9E3779B1U
#define P32_2 0x85EBCA77U
#define P32_3 0xC2B2AE3DU
#define P64_1 0x9E3779B185EBCA87ULL
#define P64_2 0xC2B2AE3D27D4EB4FULL
#define P64_3 0x165667B19E3779F9ULL
#define P64_4 0x85EBCA77C2B2AE63ULL
#define P64_5 0x27D4EB2F165667C5ULL
#define PMX_1 0x165667919E3779F9ULL
#define PMX_2 0x9FB21C651E98DF25ULL

#define SECRET_SIZE 192
#define SECRET_SIZE_MIN 136
#define STRIPE_LEN 64
#define SECRET_CONSUME_RATE 8
#define ACC_NB 8
#define MIDSIZE_MAX 240
#define MIDSIZE_START 3
#define MIDSIZE_LAST 17
#define LASTACC_START 7
#define MERGEACCS_START 11

static const uint8_t kSecret[SECRET_SIZE] = {
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c, 0xf7, 0x21, 0xad, 0x1c,
    0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb, 0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f,
    0xcb, 0x79, 0xe6, 0x4e, 0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6, 0x81, 0x3a, 0x26, 0x4c,
    0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb, 0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3,
    0x71, 0x64, 0x48, 0x97, 0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7, 0xc7, 0x0b, 0x4f, 0x1d,
    0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31, 0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64,
    0xea, 0xc5, 0xac, 0x83, 0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26, 0x29, 0xd4, 0x68, 0x9e,
    0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc, 0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce,
    0x45, 0xcb, 0x3a, 0x8f, 0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
};

static inline uint32_t rd32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static inline uint64_t rd64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}

static inline void wr64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }

static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static inline uint64_t swap64(uint64_t x) { return __builtin_bswap64(x); }

static inline uint32_t swap32(uint32_t x) { return __builtin_bswap32(x); }

/* low 64 bits of the 128-bit product xor its high 64 bits */
static inline uint64_t mul128_fold64(uint64_t a, uint64_t b) {
    unsigned __int128 p = (unsigned __int128)a * b;
    return (uint64_t)p ^ (uint64_t)(p >> 64);
}

static inline uint64_t xxh64_avalanche(uint64_t h) {
    h ^= h >> 33;
    h *= P64_2;
    h ^= h >> 29;
    h *= P64_3;
    h ^= h >> 32;
    return h;
}

static inline uint64_t xxh3_avalanche(uint64_t h) {
    h ^= h >> 37;
    h *= PMX_1;
    h ^= h >> 32;
    return h;
}

static inline uint64_t rrmxmx(uint64_t h, uint64_t len) {
    h ^= rotl64(h, 49) ^ rotl64(h, 24);
    h *= PMX_2;
    h ^= (h >> 35) + len;
    h *= PMX_2;
    return h ^ (h >> 28);
}

static uint64_t len_1to3(const uint8_t* in, size_t len, const uint8_t* sec, uint64_t seed) {
    uint8_t c1 = in[0], c2 = in[len >> 1], c3 = in[len - 1];
    uint32_t combined = ((uint32_t)c1 << 16) | ((uint32_t)c2 << 24) | (uint32_t)c3 | ((uint32_t)len << 8);
    uint64_t bitflip = (uint64_t)(rd32(sec) ^ rd32(sec + 4)) + seed;
    return xxh64_avalanche((uint64_t)combined ^ bitflip);
}

static uint64_t len_4to8(const uint8_t* in, size_t len, const uint8_t* sec, uint64_t seed) {
    seed ^= (uint64_t)swap32((uint32_t)seed) << 32;
    uint32_t in1 = rd32(in), in2 = rd32(in + len - 4);
    uint64_t bitflip = (rd64(sec + 8) ^ rd64(sec + 16)) - seed;
    uint64_t in64 = in2 + ((uint64_t)in1 << 32);
    return rrmxmx(in64 ^ bitflip, len);
}

static uint64_t len_9to16(const uint8_t* in, size_t len, const uint8_t* sec, uint64_t seed) {
    uint64_t bitflip1 = (rd64(sec + 24) ^ rd64(sec + 32)) + seed;
    uint64_t bitflip2 = (rd64(sec + 40) ^ rd64(sec + 48)) - seed;
    uint64_t lo = rd64(in) ^ bitflip1;
    uint64_t hi = rd64(in + len - 8) ^ bitflip2;
    uint64_t acc = len + swap64(lo) + hi + mul128_fold64(lo, hi);
    return xxh3_avalanche(acc);
}

static uint64_t len_0to16(const uint8_t* in, size_t len, const uint8_t* sec, uint64_t seed) {
    if (len > 8) return len_9to16(in, len, sec, seed);
    if (len >= 4) return len_4to8(in, len, sec, seed);
    if (len) return len_1to3(in, len, sec, seed);
    return xxh64_avalanche(seed ^ rd64(sec + 56) ^ rd64(sec + 64));
}

static inline uint64_t mix16(const uint8_t* in, const uint8_t* sec, uint64_t seed) {
    uint64_t lo = rd64(in), hi = rd64(in + 8);
    return mul128_fold64(lo ^ (rd64(sec) + seed), hi ^ (rd64(sec + 8) - seed));
}

static uint64_t len_17to128(const uint8_t* in, size_t len, const uint8_t* sec, uint64_t seed) {
    uint64_t acc = len * P64_1;
    if (len > 32) {
        if (len > 64) {
            if (len > 96) {
                acc += mix16(in + 48, sec + 96, seed);
                acc += mix16(in + len - 64, sec + 112, seed);
            }
            acc += mix16(in + 32, sec + 64, seed);
            acc += mix16(in + len - 48, sec + 80, seed);
        }
        acc += mix16(in + 16, sec + 32, seed);
        acc += mix16(in + len - 32, sec + 48, seed);
    }
    acc += mix16(in, sec, seed);
    acc += mix16(in + len - 16, sec + 16, seed);
    return xxh3_avalanche(acc);
}

static uint64_t len_129to240(const uint8_t* in, size_t len, const uint8_t* sec, uint64_t seed) {
    uint64_t acc = len * P64_1;
    size_t rounds = len / 16;
    for (size_t i = 0; i < 8; i++) acc += mix16(in + 16 * i, sec + 16 * i, seed);
    uint64_t acc_end = mix16(in + len - 16, sec + SECRET_SIZE_MIN - MIDSIZE_LAST, seed);
    acc = xxh3_avalanche(acc);
    for (size_t i = 8; i < rounds; i++) acc_end += mix16(in + 16 * i, sec + 16 * (i - 8) + MIDSIZE_START, seed);
    return xxh3_avalanche(acc + acc_end);
}

static inline void accumulate_512(uint64_t* acc, const uint8_t* in, const uint8_t* sec) {
    for (int i = 0; i < ACC_NB; i++) {
        uint64_t v = rd64(in + 8 * i);
        uint64_t k = v ^ rd64(sec + 8 * i);
        acc[i ^ 1] += v;
        acc[i] += (uint64_t)(uint32_t)k * (k >> 32);
    }
}

static inline void scramble(uint64_t* acc, const uint8_t* sec) {
    for (int i = 0; i < ACC_NB; i++) {
        uint64_t a = acc[i];
        a ^= a >> 47;
        a ^= rd64(sec + 8 * i);
        a *= P32_1;
        acc[i] = a;
    }
}

static uint64_t hash_long(const uint8_t* in, size_t len, const uint8_t* sec) {
    uint64_t acc[ACC_NB] = {P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1};
    const size_t stripes_per_block = (SECRET_SIZE - STRIPE_LEN) / SECRET_CONSUME_RATE;
    const size_t block_len = STRIPE_LEN * stripes_per_block;
    const size_t n_blocks = (len - 1) / block_len;
    for (size_t b = 0; b < n_blocks; b++) {
        for (size_t s = 0; s < stripes_per_block; s++)
            accumulate_512(acc, in + b * block_len + s * STRIPE_LEN, sec + s * SECRET_CONSUME_RATE);
        scramble(acc, sec + SECRET_SIZE - STRIPE_LEN);
    }
    /* the last partial block, then the input's last stripe */
    const size_t stripes = ((len - 1) - block_len * n_blocks) / STRIPE_LEN;
    for (size_t s = 0; s < stripes; s++)
        accumulate_512(acc, in + n_blocks * block_len + s * STRIPE_LEN, sec + s * SECRET_CONSUME_RATE);
    accumulate_512(acc, in + len - STRIPE_LEN, sec + SECRET_SIZE - STRIPE_LEN - LASTACC_START);
    uint64_t result = len * P64_1;
    for (int i = 0; i < 4; i++) {
        const uint8_t* s = sec + MERGEACCS_START + 16 * i;
        result += mul128_fold64(acc[2 * i] ^ rd64(s), acc[2 * i + 1] ^ rd64(s + 8));
    }
    return xxh3_avalanche(result);
}

uint64_t xxh3_64(const void* data, size_t len, uint64_t seed) {
    const uint8_t* in = (const uint8_t*)data;
    if (len <= 16) return len_0to16(in, len, kSecret, seed);
    if (len <= 128) return len_17to128(in, len, kSecret, seed);
    if (len <= MIDSIZE_MAX) return len_129to240(in, len, kSecret, seed);
    if (seed == 0) return hash_long(in, len, kSecret);
    /* a nonzero seed hashes long inputs with a secret derived from it */
    uint8_t custom[SECRET_SIZE];
    for (int i = 0; i < SECRET_SIZE / 16; i++) {
        wr64(custom + 16 * i, rd64(kSecret + 16 * i) + seed);
        wr64(custom + 16 * i + 8, rd64(kSecret + 16 * i + 8) - seed);
    }
    return hash_long(in, len, custom);
}

int xxh3_token_blocks(const uint32_t* tokens, size_t n_blocks, size_t block_size, uint64_t salt, uint64_t seed,
                      uint64_t parent, int has_parent, uint64_t* block_hashes, uint64_t* seq_hashes) {
    const size_t nbytes = block_size * 4;
    for (size_t b = 0; b < n_blocks; b++) {
        const uint32_t* blk = tokens + b * block_size;
        uint64_t h;
        if (b == 0 && !has_parent && salt) {
            uint8_t* buf = (uint8_t*)malloc(nbytes + 8);
            if (buf == NULL) return 1;
            wr64(buf, salt);
            memcpy(buf + 8, blk, nbytes);
            h = xxh3_64(buf, nbytes + 8, seed);
            free(buf);
        } else {
            h = xxh3_64(blk, nbytes, seed);
        }
        block_hashes[b] = h;
        if (b == 0 && !has_parent) {
            seq_hashes[b] = h;
        } else {
            uint64_t pair[2] = {b == 0 ? parent : seq_hashes[b - 1], h};
            seq_hashes[b] = xxh3_64(pair, 16, seed);
        }
    }
    return 0;
}
