/* hexscan.c — native hex-token scanner for the serial-log ingest path.
 *
 * Token grammar (serial_hex_to_excel_v3.py:16): whitespace-separated tokens
 * that are either two hex digits or "0x"/"0X" + two hex digits; everything
 * else is skipped.  Byte-level semantics identical to
 * slam_process_tpu_torch.io.hexlog.tokenize_hex (equivalence asserted in
 * tests/test_torch_hexscan.py).
 *
 * Exposed as a tiny C ABI for ctypes:
 *   size_t hexscan_tokenize(const uint8_t *in, size_t n, uint8_t *out);
 * `out` must have room for n/2 bytes (every emitted byte consumes >= 2
 * input chars + separator).  Returns the number of bytes written.
 *
 * Two paths share the loop:
 *
 *  - SIMD fast path (AVX-512BW + VBMI, compiled in by -march=native on
 *    hosts that have it): shipped logs are a junk prefix followed by a
 *    perfectly regular "XX " stride-3 stream, so a 192-byte block is 64
 *    tokens.  Three 64-byte loads deinterleave into the (hi, lo, sep)
 *    char planes with two vpermi2b each; classification and nibble
 *    arithmetic are mask ops; a fully regular block emits 64 output
 *    bytes with no per-token control flow.  Equivalence argument: the
 *    block starts at a token boundary (start of input or preceded by
 *    whitespace — the loop guarantees it), and every triple being
 *    (hex, hex, ws) means whitespace-splitting this block yields exactly
 *    the 64 two-hex-digit tokens the grammar accepts.  ~8x the scalar
 *    rate on one core.
 *
 *  - Scalar path: the full grammar (0x prefixes, junk runs, odd
 *    lengths).  On any irregular block the loop falls back for ONE
 *    token/whitespace run, then re-tries SIMD at the next boundary, so
 *    mid-stream junk costs a handful of scalar tokens, not the rest of
 *    the file.
 */

#include <stddef.h>
#include <stdint.h>

static const uint8_t HEX[256] = {
    /* 0x00 */ 255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    /* 0x10 */ 255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    /* 0x20 */ 255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    /* 0x30 */ 0,1,2,3,4,5,6,7,8,9,255,255,255,255,255,255,
    /* 0x40 */ 255,10,11,12,13,14,15,255,255,255,255,255,255,255,255,255,
    /* 0x50 */ 255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    /* 0x60 */ 255,10,11,12,13,14,15,255,255,255,255,255,255,255,255,255,
    /* 0x70 */ 255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    /* 0x80.. all 255 */
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
    255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
};

static inline int is_ws(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == 0x0b ||
           c == 0x0c || c == 0x1c || c == 0x1d || c == 0x1e || c == 0x1f;
}

#if defined(__AVX512BW__) && defined(__AVX512VBMI__)
#define HEXSCAN_SIMD 1
#include <immintrin.h>

/* Deinterleave char class `phase` (0 = hi digit, 1 = lo digit, 2 = sep)
 * from a 192-byte block held in l0/l1/l2: output byte k = in[3k+phase].
 * Indices 3k+phase run 0..191: the first ones come from (l0, l1) via
 * vpermi2b (7-bit selector), the tail from l2 via vpermb, merged by a
 * compile-time mask. */
static inline __m512i deint3(__m512i l0, __m512i l1, __m512i l2, int phase,
                             const uint8_t *idx01, const uint8_t *idx2,
                             uint64_t tailmask) {
    __m512i i01 = _mm512_loadu_si512((const void *)idx01);
    __m512i i2 = _mm512_loadu_si512((const void *)idx2);
    __m512i lo = _mm512_permutex2var_epi8(l0, i01, l1);
    __m512i hi = _mm512_permutexvar_epi8(i2, l2);
    (void)phase;
    return _mm512_mask_mov_epi8(lo, (__mmask64)tailmask, hi);
}

/* Per-phase permute tables + tail masks, built once. */
static uint8_t IDX01[3][64];
static uint8_t IDX2[3][64];
static uint64_t TAIL[3];
static int tables_ready = 0;

static void build_tables(void) {
    for (int phase = 0; phase < 3; phase++) {
        uint64_t tail = 0;
        for (int k = 0; k < 64; k++) {
            int j = 3 * k + phase;
            if (j < 128) {
                IDX01[phase][k] = (uint8_t)j;   /* vpermi2b: 0..127 spans a,b */
                IDX2[phase][k] = 0;
            } else {
                IDX01[phase][k] = 0;
                IDX2[phase][k] = (uint8_t)(j - 128);
                tail |= 1ULL << k;
            }
        }
        TAIL[phase] = tail;
    }
    tables_ready = 1;
}

/* Try one 192-byte block at `in` (preceded by a token boundary).  If the
 * block is 64 regular "XX " triples, write the 64 byte values to `out`
 * and return 1; otherwise write nothing and return 0. */
static inline int simd_block(const uint8_t *in, uint8_t *out) {
    __m512i l0 = _mm512_loadu_si512((const void *)in);
    __m512i l1 = _mm512_loadu_si512((const void *)(in + 64));
    __m512i l2 = _mm512_loadu_si512((const void *)(in + 128));

    __m512i c0 = deint3(l0, l1, l2, 0, IDX01[0], IDX2[0], TAIL[0]);
    __m512i c1 = deint3(l0, l1, l2, 1, IDX01[1], IDX2[1], TAIL[1]);
    __m512i c2 = deint3(l0, l1, l2, 2, IDX01[2], IDX2[2], TAIL[2]);

    const __m512i v0 = _mm512_set1_epi8('0');
    const __m512i v9 = _mm512_set1_epi8(9);
    const __m512i v5 = _mm512_set1_epi8(5);
    const __m512i va = _mm512_set1_epi8('a');
    const __m512i v20 = _mm512_set1_epi8(0x20);

    /* hex classification: digit = (c - '0') <= 9 (unsigned wrap kills
     * c < '0'); alpha = ((c | 0x20) - 'a') <= 5. */
    __m512i d0 = _mm512_sub_epi8(c0, v0);
    __m512i d1 = _mm512_sub_epi8(c1, v0);
    __m512i a0 = _mm512_sub_epi8(_mm512_or_si512(c0, v20), va);
    __m512i a1 = _mm512_sub_epi8(_mm512_or_si512(c1, v20), va);
    __mmask64 hex0 = _mm512_cmple_epu8_mask(d0, v9) |
                     _mm512_cmple_epu8_mask(a0, v5);
    __mmask64 hex1 = _mm512_cmple_epu8_mask(d1, v9) |
                     _mm512_cmple_epu8_mask(a1, v5);

    /* separator: ' ', 0x09..0x0d, 0x1c..0x1f */
    __mmask64 ws = _mm512_cmpeq_epi8_mask(c2, v20) |
                   _mm512_cmple_epu8_mask(
                       _mm512_sub_epi8(c2, _mm512_set1_epi8(0x09)),
                       _mm512_set1_epi8(4)) |
                   _mm512_cmple_epu8_mask(
                       _mm512_sub_epi8(c2, _mm512_set1_epi8(0x1c)),
                       _mm512_set1_epi8(3));

    if ((hex0 & hex1 & ws) != ~(__mmask64)0)
        return 0;

    /* nibble value: (c & 0xF) + (c >= 0x40 ? 9 : 0) */
    const __m512i nib = _mm512_set1_epi8(0x0F);
    __m512i h = _mm512_and_si512(c0, nib);
    __m512i l = _mm512_and_si512(c1, nib);
    __mmask64 al0 = _mm512_cmpge_epu8_mask(c0, _mm512_set1_epi8(0x40));
    __mmask64 al1 = _mm512_cmpge_epu8_mask(c1, _mm512_set1_epi8(0x40));
    h = _mm512_mask_add_epi8(h, al0, h, v9);
    l = _mm512_mask_add_epi8(l, al1, l, v9);

    /* b = (h << 4) | l: epi16 shift + per-byte mask keeps bytes intact. */
    __m512i hi4 = _mm512_and_si512(_mm512_slli_epi16(h, 4),
                                   _mm512_set1_epi8((char)0xF0));
    _mm512_storeu_si512((void *)out, _mm512_or_si512(hi4, l));
    return 1;
}
#endif /* AVX-512 */

size_t hexscan_tokenize(const uint8_t *in, size_t n, uint8_t *out) {
    size_t i = 0, w = 0;
#ifdef HEXSCAN_SIMD
    if (!tables_ready) build_tables();
#endif
    while (i < n) {
        /* skip whitespace */
        while (i < n && is_ws(in[i])) i++;
        if (i >= n) break;
#ifdef HEXSCAN_SIMD
        /* i is a token boundary here (start of input or after ws):
         * run SIMD blocks while they stay regular, then re-enter the
         * loop so the ws-skip re-establishes the boundary. */
        if (i + 192 <= n && simd_block(in + i, out + w)) {
            do {
                w += 64;
                i += 192;
            } while (i + 192 <= n && simd_block(in + i, out + w));
            continue;
        }
#endif
        /* one scalar token = [start, end), then re-try SIMD */
        size_t start = i;
        while (i < n && !is_ws(in[i])) i++;
        size_t len = i - start;
        if (len == 2) {
            uint8_t hi = HEX[in[start]], lo = HEX[in[start + 1]];
            if (hi != 255 && lo != 255)
                out[w++] = (uint8_t)((hi << 4) | lo);
        } else if (len == 4 && in[start] == '0' &&
                   (in[start + 1] == 'x' || in[start + 1] == 'X')) {
            uint8_t hi = HEX[in[start + 2]], lo = HEX[in[start + 3]];
            if (hi != 255 && lo != 255)
                out[w++] = (uint8_t)((hi << 4) | lo);
        }
    }
    return w;
}
