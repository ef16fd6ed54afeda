/* The serial half of the benchmark's plain FFV1 reference: the adaptive
 * binary range coder with its 32-state symbol contexts, and the adaptive
 * Golomb-Rice coder with its run mode, one slice a call.  Everything that
 * is not serial (prediction, contexts, slice layout, headers, trailers,
 * CRC) is NumPy in ffv1.py, which hands this file each slice's symbols in
 * coding order.  Written from RFC 9043 and FFmpeg's rangecoder.h,
 * ffv1enc.c and ffv1enc_template.c; it shares no code with the program
 * under test.  Built by build.py with the host's C compiler, loaded with
 * ctypes; no call touches Python objects.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* range coder (rangecoder.h: put_rac, renorm_encoder, ff_rac_terminate) */

typedef struct {
    uint32_t low, range;
    int outstanding_count, outstanding_byte;
    uint8_t *out;
    int64_t pos, cap;
    const uint8_t *one, *zero;
    int64_t decisions;
} Rac;

static void out_byte(Rac *c, int b) {
    if (c->pos < c->cap) c->out[c->pos] = (uint8_t)b;
    c->pos++;
}

static void renorm(Rac *c) {
    while (c->range < 0x100) {
        if (c->outstanding_byte < 0) {
            c->outstanding_byte = (int)(c->low >> 8);
        } else if (c->low <= 0xFF00) {
            out_byte(c, c->outstanding_byte);
            for (; c->outstanding_count; c->outstanding_count--) out_byte(c, 0xFF);
            c->outstanding_byte = (int)(c->low >> 8);
        } else if (c->low >= 0x10000) {
            out_byte(c, (c->outstanding_byte + 1) & 0xFF);
            for (; c->outstanding_count; c->outstanding_count--) out_byte(c, 0x00);
            c->outstanding_byte = (int)((c->low >> 8) & 0xFF);
        } else {
            c->outstanding_count++;
        }
        c->low = (c->low & 0xFF) << 8;
        c->range <<= 8;
    }
}

static void put_rac(Rac *c, uint8_t *st, int bit) {
    c->decisions++;
    uint32_t r1 = (c->range * (uint32_t)*st) >> 8;
    if (!bit) {
        c->range -= r1;
        *st = c->zero[*st];
    } else {
        c->low += c->range - r1;
        c->range = r1;
        *st = c->one[*st];
    }
    renorm(c);
}

static void rac_init(Rac *c, const uint8_t *one, const uint8_t *zero,
                     uint8_t *out, int64_t cap) {
    c->low = 0;
    c->range = 0xFF00;
    c->outstanding_count = 0;
    c->outstanding_byte = -1;
    c->out = out;
    c->pos = 0;
    c->cap = cap;
    c->one = one;
    c->zero = zero;
    c->decisions = 0;
}

/* ff_rac_terminate(c, 1): a zero bit at state 129, then the flush */
static void rac_terminate(Rac *c) {
    uint8_t st = 129;
    put_rac(c, &st, 0);
    c->range = 0xFF;
    c->low += 0xFF;
    renorm(c);
    c->range = 0xFF;
    renorm(c);
}

/* put_symbol: a zero flag, the exponent in unary, the mantissa, the sign */
static void put_symbol(Rac *c, uint8_t *st, int v, int is_signed) {
    if (!v) {
        put_rac(c, st, 1);
        return;
    }
    int a = v < 0 ? -v : v;
    int e = 31 - __builtin_clz((unsigned)a);
    put_rac(c, st, 0);
    for (int i = 0; i < e; i++) put_rac(c, st + 1 + (i < 9 ? i : 9), 1);
    put_rac(c, st + 1 + (e < 9 ? e : 9), 0);
    for (int i = e - 1; i >= 0; i--)
        put_rac(c, st + 22 + (i < 9 ? i : 9), (a >> i) & 1);
    if (is_signed) put_rac(c, st + 11 + (e < 10 ? e : 10), v < 0);
}

/* the frame's key bit (slice 0 only, keybit >= 0) and the slice header's
 * unsigned symbols, each header with a fresh 32-state vector */
static void put_prefix(Rac *c, int keybit, const int32_t *hdr, int nhdr) {
    if (keybit >= 0) {
        uint8_t ks = 128;
        put_rac(c, &ks, keybit);
    }
    uint8_t hs[32];
    memset(hs, 128, sizeof hs);
    for (int i = 0; i < nhdr; i++) put_symbol(c, hs, hdr[i], 0);
}

/* One range-coded slice: the prefix, then each sample's signed symbol
 * vals[i] with the 32 states at row rows[i] of states (n_rows x 32,
 * updated in place).  Returns the slice's byte count (more than cap: the
 * bytes past cap were not written); counts[0] gets the binary decisions
 * coded, the terminator's included. */
int64_t ref_rac_slice(const uint8_t *one, const uint8_t *zero, int keybit,
                      const int32_t *hdr, int nhdr, const int32_t *rows,
                      const int32_t *vals, int64_t n, uint8_t *states,
                      uint8_t *out, int64_t cap, int64_t *counts) {
    Rac c;
    rac_init(&c, one, zero, out, cap);
    put_prefix(&c, keybit, hdr, nhdr);
    for (int64_t i = 0; i < n; i++)
        put_symbol(&c, states + 32 * (int64_t)rows[i], vals[i], 1);
    rac_terminate(&c);
    counts[0] = c.decisions;
    return c.pos;
}

/* ------------------------------------------------------------------ */
/* Golomb-Rice (ffv1enc.c: put_vlc_symbol, update_vlc_state;
 * ffv1enc_template.c: encode_line's run mode; golomb.h: set_ur_golomb) */

typedef struct {
    uint8_t *out;
    int64_t pos, cap;
    uint64_t acc;
    int nbits;
} Bits;

static void put_bits(Bits *b, int n, uint32_t v) {
    if (!n) return;
    b->acc = (b->acc << n) | (v & ((n == 32) ? 0xFFFFFFFFu : ((1u << n) - 1)));
    b->nbits += n;
    while (b->nbits >= 8) {
        b->nbits -= 8;
        if (b->pos < b->cap) b->out[b->pos] = (uint8_t)(b->acc >> b->nbits);
        b->pos++;
    }
    b->acc &= (1ull << b->nbits) - 1;
}

static void flush_bits(Bits *b) {
    if (b->nbits) put_bits(b, 8 - b->nbits, 0);
}

static const int log2_run[41] = {
    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24};

/* a VLC context: drift, error_sum, bias, count (as int32) */
enum { DRIFT, ERR, BIAS, COUNT };

static int fold(int v, int bits) {
    int m = (1 << bits) - 1;
    v &= m;
    if (v & (1 << (bits - 1))) v -= 1 << bits;
    return v;
}

static void put_vlc_symbol(Bits *b, int32_t *s, int v, int bits) {
    v = fold(v - s[BIAS], bits);
    int k = 0;
    for (int i = s[COUNT]; i < s[ERR]; i += i) k++;
    int code = (2 * s[DRIFT] + s[COUNT]) >= 0 ? v : -v - 1;
    unsigned u = code >= 0 ? 2u * (unsigned)code : (unsigned)(-2 * code - 1);
    const int limit = 12;
    unsigned e = u >> k;
    if (e < (unsigned)limit)
        put_bits(b, (int)e + k + 1, (1u << k) + (u & ((1u << k) - 1)));
    else
        put_bits(b, limit + bits, u - limit + 1);
    /* update_vlc_state */
    int drift = s[DRIFT] + v, count = s[COUNT];
    s[ERR] = (s[ERR] + (v < 0 ? -v : v)) & 0xFFFF;
    if (count == 128) {
        count >>= 1;
        drift >>= 1;
        s[ERR] >>= 1;
    }
    count++;
    if (drift <= -count) {
        s[BIAS] = s[BIAS] - 1 < -128 ? -128 : s[BIAS] - 1;
        drift = drift + count > -count + 1 ? drift + count : -count + 1;
    } else if (drift > 0) {
        s[BIAS] = s[BIAS] + 1 > 127 ? 127 : s[BIAS] + 1;
        drift = drift - count < 0 ? drift - count : 0;
    }
    s[DRIFT] = drift;
    s[COUNT] = count;
}

/* One Golomb-Rice slice: the prefix range-coded and terminated, then the
 * planes' samples as bits.  Plane p has pw[p] x ph[p] samples at offset
 * poff[p] of ctx/diff and codes with the VLC contexts from row prow[p] of
 * vlc (n_rows x 4, updated in place).  Returns the byte count (more than
 * cap: the bytes past cap were not written); counts[0] gets the Rice codes
 * written, counts[1] the runs that run mode ended. */
int64_t ref_rice_slice(const uint8_t *one, const uint8_t *zero, int keybit,
                       const int32_t *hdr, int nhdr, int nplanes,
                       const int32_t *pw, const int32_t *ph,
                       const int64_t *poff, const int32_t *prow,
                       const int32_t *ctx, const int32_t *diff, int bits,
                       int32_t *vlc, uint8_t *out, int64_t cap,
                       int64_t *counts) {
    Rac c;
    rac_init(&c, one, zero, out, cap);
    put_prefix(&c, keybit, hdr, nhdr);
    rac_terminate(&c);
    Bits b = {out + (c.pos < cap ? c.pos : cap), 0,
              cap > c.pos ? cap - c.pos : 0, 0, 0};
    int64_t codes = 0, runs = 0;
    for (int p = 0; p < nplanes; p++) {
        int run_index = 0;
        int32_t *base = vlc + 4 * (int64_t)prow[p];
        for (int y = 0; y < ph[p]; y++) {
            const int32_t *cx = ctx + poff[p] + (int64_t)y * pw[p];
            const int32_t *dx = diff + poff[p] + (int64_t)y * pw[p];
            int run_count = 0, run_mode = 0;
            for (int x = 0; x < pw[p]; x++) {
                int context = cx[x], d = dx[x];
                if (context == 0) run_mode = 1;
                if (run_mode) {
                    if (d) {
                        while (run_count >= (1 << log2_run[run_index])) {
                            run_count -= 1 << log2_run[run_index];
                            run_index++;
                            put_bits(&b, 1, 1);
                        }
                        put_bits(&b, 1 + log2_run[run_index], (uint32_t)run_count);
                        runs++;
                        if (run_index) run_index--;
                        run_count = 0;
                        run_mode = 0;
                        if (d > 0) d--;
                    } else {
                        run_count++;
                    }
                }
                if (!run_mode) {
                    put_vlc_symbol(&b, base + 4 * (int64_t)context, d, bits);
                    codes++;
                }
            }
            if (run_mode) {
                while (run_count >= (1 << log2_run[run_index])) {
                    run_count -= 1 << log2_run[run_index];
                    run_index++;
                    put_bits(&b, 1, 1);
                }
                if (run_count) put_bits(&b, 1, 1);
                runs++;
            }
        }
    }
    flush_bits(&b);
    counts[0] = codes;
    counts[1] = runs;
    return c.pos + b.pos;
}
