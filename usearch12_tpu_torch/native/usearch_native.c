/* Native host kernels for usearch12_tpu.
 *
 * Exact reimplementation of the hot per-pair alignment path documented in
 * the Python oracle modules (align/oracle.py, align/hsp.py,
 * align/global_aligner.py), against which this file is tested cell-for-cell:
 *   - banded / full affine-gap global NW with 4-bit traceback
 *     (semantics of usearch12 src/viterbifastbandmem.cpp:12-253,
 *      src/viterbifastmem.cpp:9-170, src/tracebackbitmem.cpp:8-73)
 *   - ungapped x-drop HSP finding with MaxReps=8 word dictionary
 *     (src/ungappedblast.cpp:8-211, src/hspfinder.cpp:304-331)
 *   - collinear chain sweep (src/chainer.cpp:352-500)
 *   - HSP-anchored global alignment composition
 *     (src/globalalignmem.cpp:25-236)
 *
 * Plain C, IEEE float arithmetic (no fast-math), deterministic.
 * Exposed via ctypes; all buffers caller-allocated numpy arrays.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include <stddef.h>

#define TB_DM 0x01
#define TB_IM 0x02
#define TB_MD 0x04
#define TB_MI 0x08

#define NEG_INF (-9e9f)
#define MAX_REPS 8

typedef unsigned char byte;

/* 12-penalty gap model, order matches Python AlnParams fields */
typedef struct {
    float open_a, open_b, ext_a, ext_b;
    float l_open_a, l_open_b, r_open_a, r_open_b;
    float l_ext_a, l_ext_b, r_ext_a, r_ext_b;
} GapParams;

/* ---------------- banded NW ---------------- */

static void get_range_j(uint32_t la, uint32_t lb, uint32_t dlo, uint32_t dhi,
                        uint32_t i, uint32_t *startj, uint32_t *endj)
{
    uint32_t s = (dlo + i >= la) ? dlo + i - la : 0;
    if (s >= lb)
        s = lb - 1;
    uint32_t e = (dhi + i + 1 >= la) ? dhi + i + 1 - la : 0;
    if (e > lb)
        e = lb;
    *startj = s;
    *endj = e;
}

/* Traceback storage is BAND-RELATIVE when the band is narrower than the
 * row: row i occupies stride_b = (dhi-dlo+1)+2 bytes — slot 0 holds the
 * j = startj-1 TB_IM marker, slots 1..bw the band cells, slot bw+1 the
 * j = lb Drow column.  A full (la+1)*(lb+1) byte matrix made every row
 * write a fresh page for long sequences (24 kb holes: 576 MB touched,
 * ~30x slowdown vs the band's 840 KB).  Caller workspace contract is
 * unchanged: (la+1)*(lb+1) bytes covers both layouts (band layout is
 * used only when stride_b <= lb+1). */
int nw_band(const byte *a, uint32_t la, const byte *b, uint32_t lb,
            uint32_t dlo, uint32_t dhi, const GapParams *gp,
            const float *mx /*256x256*/,
            byte *tb /* (la+1)*(lb+1) */, float *mrow_buf /* lb+2 */,
            float *drow /* lb+1 */, char *path_out /* la+lb+1 */,
            float *score_out)
{
    if (la == 0 || lb == 0 || dlo > dhi)
        return -1;
    float *mrow = mrow_buf + 1; /* mrow[-1] valid */
    uint32_t j, i;
    mrow[-1] = NEG_INF;
    for (j = 0; j <= lb; ++j) {
        mrow[j] = NEG_INF;
        drow[j] = NEG_INF;
    }

    float open_a = gp->l_open_a;
    float ext_a = gp->l_ext_a;
    uint32_t startj = 0, endj = 0;
    uint32_t bw = dhi - dlo + 1;
    int banded_tb = ((size_t)bw + 2 <= (size_t)lb + 1);
    size_t stride = banded_tb ? (size_t)bw + 2 : (size_t)lb + 1;
    size_t lb_slot = banded_tb ? (size_t)bw + 1 : (size_t)lb;

    for (i = 0; i < la; ++i) {
        get_range_j(la, lb, dlo, dhi, i, &startj, &endj);
        if (endj == 0)
            continue;
        float open_b = (startj == 0) ? gp->l_open_b : gp->open_b;
        float ext_b = (startj == 0) ? gp->l_ext_b : gp->ext_b;

        const float *mx_row = mx + 256 * (size_t)a[i];
        float i0 = NEG_INF;
        float m0;
        if (i == 0)
            m0 = 0.0f;
        else
            m0 = (startj == 0) ? NEG_INF : mrow[(int32_t)startj - 1];

        byte *tbrow = tb + stride * i;
        byte *tbp = banded_tb ? (tbrow + 1 - (ptrdiff_t)startj) : tbrow;
        if (startj > 0)
            tbp[startj - 1] = TB_IM;

        for (j = startj; j < endj; ++j) {
            byte bb = b[j];
            float saved_m0 = m0;
            /* branchless cell: same float-op DAG and tie preferences as
             * the reference (D beats M on >, I beats both on >; M beats
             * D/I extension on >=), but with cmov/maxss instead of
             * data-dependent branches (random data mispredicts ~half) */
            float dj = drow[j];
            byte bits = (dj > m0) ? TB_DM : 0;
            float xm = (dj > m0) ? dj : m0;
            bits = (i0 > xm) ? TB_IM : bits;
            xm = (i0 > xm) ? i0 : xm;
            m0 = mrow[j];
            mrow[j] = xm + mx_row[bb];
            float md = saved_m0 + open_b;
            float de = dj + ext_b;
            bits |= (md >= de) ? TB_MD : 0;
            drow[j] = (md >= de) ? md : de;
            float mi = saved_m0 + open_a;
            float ie = i0 + ext_a;
            bits |= (mi >= ie) ? TB_MI : 0;
            i0 = (mi >= ie) ? mi : ie;
            open_b = gp->open_b;
            ext_b = gp->ext_b;
            tbp[j] = bits;
        }

        /* special case for end of Drow (runs every row, M0 = DPM[i][endj]) */
        tbrow[lb_slot] = 0;
        {
            float md = m0 + gp->r_open_b;
            drow[lb] += gp->r_ext_b;
            if (md >= drow[lb]) {
                drow[lb] = md;
                tbrow[lb_slot] = TB_MD;
            }
        }
        m0 = NEG_INF;
        open_a = gp->open_a;
        ext_a = gp->ext_a;
    }

    /* last row of DPI */
    get_range_j(la, lb, dlo, dhi, la - 1, &startj, &endj);
    if (endj != lb)
        return -2;
    byte *tbrow = tb + stride * la;
    byte *tbp = banded_tb ? (tbrow + 1 - (ptrdiff_t)startj) : tbrow;
    float i1 = NEG_INF;
    mrow[(int32_t)startj - 1] = NEG_INF;
    for (j = startj; j < endj; ++j) {
        tbp[j] = 0;
        float mi = mrow[(int32_t)j - 1] + gp->r_open_a;
        i1 += gp->r_ext_a;
        if (mi > i1) {
            i1 = mi;
            tbp[j] = TB_MI;
        }
    }

    float final_m = mrow[lb - 1];
    float final_d = drow[lb];
    float final_i = i1;
    float score = final_m;
    char state = 'M';
    if (final_d > score) {
        score = final_d;
        state = 'D';
    }
    if (final_i > score) {
        score = final_i;
        state = 'I';
    }
    *score_out = score;

    /* traceback */
    {
        size_t pos = 0;
        uint32_t ii = la, jj = lb;
        char *p = path_out;
#define TB_AT(I, J)                                                        \
        (banded_tb                                                         \
         ? tb[stride * (I) +                                               \
              ((J) == lb ? lb_slot                                         \
               : ({ uint32_t s_, e_;                                       \
                    get_range_j(la, lb, dlo, dhi,                          \
                                (I) < la ? (I) : la - 1, &s_, &e_);        \
                    (size_t)((J) + 1 <= s_ ? 0                             \
                             : ((J) - s_ + 1 > bw ? bw : (J) - s_ + 1)); }))] \
         : tb[stride * (I) + (J)])
        while (!(ii == 0 && jj == 0)) {
            p[pos++] = state;
            if (state == 'M') {
                if (ii == 0 || jj == 0)
                    return -3;
                byte t = TB_AT(ii - 1, jj - 1);
                state = (t & TB_DM) ? 'D' : ((t & TB_IM) ? 'I' : 'M');
                --ii;
                --jj;
            } else if (state == 'D') {
                if (ii == 0)
                    return -3;
                byte t = TB_AT(ii - 1, jj);
                state = (t & TB_MD) ? 'M' : 'D';
                --ii;
            } else {
                if (jj == 0)
                    return -3;
                byte t = TB_AT(ii, jj - 1);
                state = (t & TB_MI) ? 'M' : 'I';
                --jj;
            }
        }
#undef TB_AT
        /* reverse in place */
        for (size_t x = 0; x < pos / 2; ++x) {
            char tmp = p[x];
            p[x] = p[pos - 1 - x];
            p[pos - 1 - x] = tmp;
        }
        p[pos] = 0;
        return (int)pos;
    }
}

/* Full-matrix NW (ViterbiFastMem): banded code except final DPI row starts
 * at j=1 and rows always span [0, lb). */
int nw_full(const byte *a, uint32_t la, const byte *b, uint32_t lb,
            const GapParams *gp, const float *mx, byte *tb, float *mrow_buf,
            float *drow, char *path_out, float *score_out)
{
    if (la == 0 || lb == 0)
        return -1;
    float *mrow = mrow_buf + 1;
    uint32_t i, j;
    mrow[-1] = NEG_INF;
    for (j = 0; j <= lb; ++j) {
        mrow[j] = NEG_INF;
        drow[j] = NEG_INF;
    }
    size_t stride = (size_t)lb + 1;
    float open_a = gp->l_open_a, ext_a = gp->l_ext_a;
    float m0 = 0.0f;
    for (i = 0; i < la; ++i) {
        const float *mx_row = mx + 256 * (size_t)a[i];
        float open_b = gp->l_open_b, ext_b = gp->l_ext_b;
        float i0 = NEG_INF;
        byte *tbrow = tb + stride * i;
        for (j = 0; j < lb; ++j) {
            float saved_m0 = m0;
            /* branchless cell — see nw_band for the exact-parity notes */
            float dj = drow[j];
            byte bits = (dj > m0) ? TB_DM : 0;
            float xm = (dj > m0) ? dj : m0;
            bits = (i0 > xm) ? TB_IM : bits;
            xm = (i0 > xm) ? i0 : xm;
            m0 = mrow[j];
            mrow[j] = xm + mx_row[b[j]];
            float md = saved_m0 + open_b;
            float de = dj + ext_b;
            bits |= (md >= de) ? TB_MD : 0;
            drow[j] = (md >= de) ? md : de;
            float mi = saved_m0 + open_a;
            float ie = i0 + ext_a;
            bits |= (mi >= ie) ? TB_MI : 0;
            i0 = (mi >= ie) ? mi : ie;
            open_b = gp->open_b;
            ext_b = gp->ext_b;
            tbrow[j] = bits;
        }
        tbrow[lb] = 0;
        {
            float md = m0 + gp->r_open_b;
            drow[lb] += gp->r_ext_b;
            if (md >= drow[lb]) {
                drow[lb] = md;
                tbrow[lb] = TB_MD;
            }
        }
        m0 = NEG_INF;
        open_a = gp->open_a;
        ext_a = gp->ext_a;
    }
    byte *tbrow = tb + stride * la;
    float i1 = NEG_INF;
    for (j = 1; j < lb; ++j) {
        tbrow[j] = 0;
        float mi = mrow[(int32_t)j - 1] + gp->r_open_a;
        i1 += gp->r_ext_a;
        if (mi > i1) {
            i1 = mi;
            tbrow[j] = TB_MI;
        }
    }
    float final_m = mrow[lb - 1];
    float final_d = drow[lb];
    float final_i = i1;
    float score = final_m;
    char state = 'M';
    if (final_d > score) {
        score = final_d;
        state = 'D';
    }
    if (final_i > score) {
        score = final_i;
        state = 'I';
    }
    *score_out = score;
    {
        size_t pos = 0;
        uint32_t ii = la, jj = lb;
        char *p = path_out;
        while (!(ii == 0 && jj == 0)) {
            p[pos++] = state;
            if (state == 'M') {
                if (ii == 0 || jj == 0)
                    return -3;
                byte t = tb[stride * (ii - 1) + (jj - 1)];
                state = (t & TB_DM) ? 'D' : ((t & TB_IM) ? 'I' : 'M');
                --ii;
                --jj;
            } else if (state == 'D') {
                if (ii == 0)
                    return -3;
                byte t = tb[stride * (ii - 1) + jj];
                state = (t & TB_MD) ? 'M' : 'D';
                --ii;
            } else {
                if (jj == 0)
                    return -3;
                byte t = tb[stride * ii + (jj - 1)];
                state = (t & TB_MI) ? 'M' : 'I';
                --jj;
            }
        }
        for (size_t x = 0; x < pos / 2; ++x) {
            char tmp = p[x];
            p[x] = p[pos - 1 - x];
            p[pos - 1 - x] = tmp;
        }
        p[pos] = 0;
        return (int)pos;
    }
}

/* ---------------- HSP finder ---------------- */

typedef struct {
    uint32_t loi, loj, leni, lenj;
    float score;
} HSPc;

typedef struct {
    uint32_t word_length;
    uint32_t alpha_size;
    uint32_t word_count;
    const float *mx;           /* 256x256 */
    const byte *char_to_letter; /* 256 */
    /* A-side dictionary */
    uint32_t *word_counts_a;   /* word_count */
    uint32_t *word_to_pos_a;   /* word_count * MAX_REPS */
    uint32_t *words_a;         /* capacity */
    uint32_t *words_b;
    const uint32_t *wb;        /* current B words (owned buffer or an
                                * external cache via hsp_set_b_view) */
    uint32_t cap_a, cap_b;
    const byte *a;
    const byte *b;
    uint32_t la, lb;
    uint32_t n_words_a, n_words_b;
    /* touched words for sparse clearing */
    uint32_t *touched;
    uint32_t n_touched;
    /* compact 32x32 score table indexed by (byte & 31): exact for
     * letter bytes because the matrices are case-blind (engine
     * sequences contain only letters — the parser strips everything
     * else); fits L1 where the 256x256 table thrashes L2 in the
     * x-drop extension loops */
    float mx32[32 * 32];
    /* integer-scaled mirror of mx32 (iscale = 0 when the matrix does
     * not quantize): the x-drop extension's serial float-add chain
     * (4-5 cycle latency each) becomes 1-cycle int adds.  Exact: the
     * scaled scores are integers, score comparisons are integer, the
     * running x-drop test n > x*s is n > floor(x*s), and the final
     * score converts back by a power-of-two divide. */
    int32_t imx32[32 * 32];
    int32_t iscale;
} HSPFinderC;

static uint32_t seq_to_hsp_words(const byte *seq, uint32_t L, uint32_t w,
                                 uint32_t alpha_size,
                                 const byte *char_to_letter, uint32_t *words)
{
    if (L < w)
        return 0;
    uint32_t n = L - w + 1;
    uint32_t i;
    uint64_t hi = 1;
    for (i = 0; i < w - 1; ++i)
        hi *= alpha_size;
    uint32_t word = 0;
    for (i = 0; i < w - 1; ++i) {
        uint32_t let = char_to_letter[seq[i]];
        if (let >= alpha_size)
            let = 0;
        word = word * alpha_size + let;
    }
    for (i = 0; i < n; ++i) {
        uint32_t let = char_to_letter[seq[i + w - 1]];
        if (let >= alpha_size)
            let = 0;
        word = word * alpha_size + let;
        words[i] = word;
        uint32_t back = char_to_letter[seq[i]];
        if (back >= alpha_size)
            back = 0;
        word -= (uint32_t)(back * hi);
    }
    return n;
}

HSPFinderC *hsp_create(uint32_t word_length, uint32_t alpha_size,
                       const float *mx, const byte *char_to_letter)
{
    HSPFinderC *hf = (HSPFinderC *)calloc(1, sizeof(HSPFinderC));
    hf->word_length = word_length;
    hf->alpha_size = alpha_size;
    uint32_t wc = 1;
    for (uint32_t i = 0; i < word_length; ++i)
        wc *= alpha_size;
    hf->word_count = wc;
    hf->mx = mx;
    for (uint32_t x = 0; x < 32; ++x)
        for (uint32_t y = 0; y < 32; ++y) {
            uint32_t bx = (x >= 1 && x <= 26) ? 64 + x : x;
            uint32_t by = (y >= 1 && y <= 26) ? 64 + y : y;
            hf->mx32[x * 32 + y] = mx[256 * bx + by];
        }
    hf->iscale = 0;
    for (int sc = 1; sc <= 16; sc *= 2) {
        int ok = 1;
        for (uint32_t k = 0; k < 32 * 32 && ok; ++k) {
            float v = hf->mx32[k] * (float)sc;
            if (v != (float)(int32_t)v || v > 1e6f || v < -1e6f)
                ok = 0;
        }
        if (ok) {
            for (uint32_t k = 0; k < 32 * 32; ++k)
                hf->imx32[k] = (int32_t)(hf->mx32[k] * (float)sc);
            hf->iscale = sc;
            break;
        }
    }
    hf->char_to_letter = char_to_letter;
    hf->word_counts_a = (uint32_t *)calloc(wc, sizeof(uint32_t));
    hf->word_to_pos_a = (uint32_t *)malloc((size_t)wc * MAX_REPS * sizeof(uint32_t));
    hf->cap_a = hf->cap_b = 0;
    hf->words_a = hf->words_b = NULL;
    hf->touched = NULL;
    hf->n_touched = 0;
    return hf;
}

void hsp_destroy(HSPFinderC *hf)
{
    if (!hf)
        return;
    free(hf->word_counts_a);
    free(hf->word_to_pos_a);
    free(hf->words_a);
    free(hf->words_b);
    free(hf->touched);
    free(hf);
}

void hsp_set_a(HSPFinderC *hf, const byte *a, uint32_t la)
{
    if (la + 1 > hf->cap_a) {
        free(hf->words_a);
        free(hf->touched);
        hf->cap_a = la + 512;
        hf->words_a = (uint32_t *)malloc(hf->cap_a * sizeof(uint32_t));
        hf->touched = (uint32_t *)malloc(hf->cap_a * sizeof(uint32_t));
    }
    /* sparse clear of previous dictionary */
    for (uint32_t i = 0; i < hf->n_touched; ++i)
        hf->word_counts_a[hf->touched[i]] = 0;
    hf->n_touched = 0;

    hf->a = a;
    hf->la = la;
    hf->n_words_a = seq_to_hsp_words(a, la, hf->word_length, hf->alpha_size,
                                     hf->char_to_letter, hf->words_a);
    for (uint32_t pos = 0; pos < hf->n_words_a; ++pos) {
        uint32_t w = hf->words_a[pos];
        uint32_t n = hf->word_counts_a[w];
        if (n == 0)
            hf->touched[hf->n_touched++] = w;
        if (n == MAX_REPS)
            continue;
        hf->word_to_pos_a[(size_t)w * MAX_REPS + n] = pos;
        hf->word_counts_a[w] = n + 1;
    }
}

void hsp_set_b(HSPFinderC *hf, const byte *b, uint32_t lb)
{
    if (lb + 1 > hf->cap_b) {
        free(hf->words_b);
        hf->cap_b = lb + 512;
        hf->words_b = (uint32_t *)malloc(hf->cap_b * sizeof(uint32_t));
    }
    hf->b = b;
    hf->lb = lb;
    hf->n_words_b = seq_to_hsp_words(b, lb, hf->word_length, hf->alpha_size,
                                     hf->char_to_letter, hf->words_b);
    hf->wb = hf->words_b;
}

/* set B from a precomputed word list (target-words cache): no
 * re-extraction, the caller guarantees `words` matches
 * seq_to_hsp_words(b, lb, ...) */
uint32_t hsp_b_word_count(const HSPFinderC *hf)
{
    return hf->n_words_b;
}

const uint32_t *hsp_b_words(const HSPFinderC *hf)
{
    return hf->wb;
}

void hsp_set_b_view(HSPFinderC *hf, const byte *b, uint32_t lb,
                    const uint32_t *words, uint32_t n_words)
{
    hf->b = b;
    hf->lb = lb;
    hf->wb = words;
    hf->n_words_b = n_words;
}

static int is_global_hsp(uint32_t alo, uint32_t blo, uint32_t length,
                         uint32_t la, uint32_t lb)
{
    (void)length;
    if (la <= lb) {
        uint32_t max_gap = la / 4 + 1;
        if (alo > blo && alo - blo > max_gap)
            return 0;
        uint32_t ar = la - alo, br = lb - blo;
        if (ar > br && ar - br > max_gap)
            return 0;
    } else {
        uint32_t max_gap = lb / 4 + 1;
        if (blo > alo && blo - alo > max_gap)
            return 0;
        uint32_t ar = la - alo, br = lb - blo;
        if (br > ar && br - ar > max_gap)
            return 0;
    }
    return 1;
}

/* UngappedBlast; returns number of HSPs written to out (cap max_out). */
uint32_t hsp_ungapped_blast(HSPFinderC *hf, float x, int stagger_ok,
                            uint32_t min_length, float min_score,
                            HSPc *out, uint32_t max_out)
{
    uint32_t n_out = 0;
    uint32_t w = hf->word_length;
    const byte *a = hf->a, *b = hf->b;
    uint32_t la = hf->la, lb = hf->lb;
    if (lb < 2 * w)
        return 0;
    const float *mx32 = hf->mx32;

    if (hf->iscale) {
        /* integer-scaled extension: exact (see imx32 comment) with
         * 1-cycle adds on the serial dependency chain */
        const int32_t *imx = hf->imx32;
        const int32_t sc = hf->iscale;
        const int32_t xi = (int32_t)floorf(x * (float)sc);
        uint32_t bpos = 0;
        while (bpos < hf->n_words_b) {
            uint32_t word = hf->wb[bpos];
            uint32_t na = hf->word_counts_a[word];
            if (na == 0) {
                ++bpos;
                continue;
            }
            int found = 0;
            for (uint32_t r = 0; r < na; ++r) {
                uint32_t apos =
                    hf->word_to_pos_a[(size_t)word * MAX_REPS + r];
                uint32_t diag = la + bpos - apos;
                uint32_t bpos2 = bpos + w - 1;
                uint32_t apos2 = apos + w - 1;
                if (apos2 >= la || bpos2 >= lb)
                    continue;
                int32_t score = 0;
                for (uint32_t jj = 0; jj < w; ++jj)
                    score += imx[((a[apos + jj] & 31u) << 5)
                                 | (b[bpos + jj] & 31u)];
                int32_t best_score = score;
                uint32_t best_bpos2 = bpos2;
                for (;;) {
                    ++bpos2;
                    if (bpos2 >= lb)
                        break;
                    ++apos2;
                    if (apos2 >= la)
                        break;
                    score += imx[((a[apos2] & 31u) << 5)
                                 | (b[bpos2] & 31u)];
                    if (score > best_score) {
                        best_score = score;
                        best_bpos2 = bpos2;
                    } else if (best_score - score > xi)
                        break;
                }
                uint32_t apos1 = apos, bpos1 = bpos;
                uint32_t best_bpos1 = bpos1;
                score = best_score;
                for (;;) {
                    if (bpos1 == 0 || apos1 == 0)
                        break;
                    --bpos1;
                    --apos1;
                    score += imx[((a[apos1] & 31u) << 5)
                                 | (b[bpos1] & 31u)];
                    if (score > best_score) {
                        best_score = score;
                        best_bpos1 = bpos1;
                    } else if (best_score - score > xi)
                        break;
                }
                uint32_t blo = best_bpos1, bhi = best_bpos2;
                uint32_t length = bhi - blo + 1;
                uint32_t alo = la + best_bpos1 - diag;
                float fbest = (float)best_score / (float)sc;
                int ok = (length >= min_length && fbest >= min_score);
                if (!stagger_ok)
                    ok = ok && is_global_hsp(alo, blo, length, la, lb);
                if (ok) {
                    if (n_out < max_out) {
                        out[n_out].loi = alo;
                        out[n_out].loj = blo;
                        out[n_out].leni = length;
                        out[n_out].lenj = length;
                        out[n_out].score = fbest;
                        ++n_out;
                    }
                    bpos = bhi + 1;
                    found = 1;
                    break;
                }
            }
            if (!found)
                ++bpos;
        }
        return n_out;
    }

    uint32_t bpos = 0;
    while (bpos < hf->n_words_b) {
        uint32_t word = hf->wb[bpos];
        uint32_t na = hf->word_counts_a[word];
        if (na == 0) {
            ++bpos;
            continue;
        }
        int found = 0;
        for (uint32_t r = 0; r < na; ++r) {
            uint32_t apos = hf->word_to_pos_a[(size_t)word * MAX_REPS + r];
            uint32_t diag = la + bpos - apos;
            uint32_t bpos2 = bpos + w - 1;
            uint32_t apos2 = apos + w - 1;
            if (apos2 >= la || bpos2 >= lb)
                continue;
            float score = 0.0f;
            for (uint32_t jj = 0; jj < w; ++jj)
                score += mx32[((a[apos + jj] & 31u) << 5)
                              | (b[bpos + jj] & 31u)];
            float best_score = score;
            uint32_t best_bpos2 = bpos2;
            for (;;) {
                ++bpos2;
                if (bpos2 >= lb)
                    break;
                ++apos2;
                if (apos2 >= la)
                    break;
                score += mx32[((a[apos2] & 31u) << 5)
                              | (b[bpos2] & 31u)];
                if (score > best_score) {
                    best_score = score;
                    best_bpos2 = bpos2;
                } else if (best_score - score > x)
                    break;
            }
            uint32_t apos1 = apos, bpos1 = bpos;
            uint32_t best_bpos1 = bpos1;
            score = best_score;
            for (;;) {
                if (bpos1 == 0 || apos1 == 0)
                    break;
                --bpos1;
                --apos1;
                score += mx32[((a[apos1] & 31u) << 5)
                              | (b[bpos1] & 31u)];
                if (score > best_score) {
                    best_score = score;
                    best_bpos1 = bpos1;
                } else if (best_score - score > x)
                    break;
            }
            uint32_t blo = best_bpos1, bhi = best_bpos2;
            uint32_t length = bhi - blo + 1;
            uint32_t alo = la + best_bpos1 - diag;
            int ok = (length >= min_length && best_score >= min_score);
            if (!stagger_ok)
                ok = ok && is_global_hsp(alo, blo, length, la, lb);
            if (ok) {
                if (n_out < max_out) {
                    out[n_out].loi = alo;
                    out[n_out].loj = blo;
                    out[n_out].leni = length;
                    out[n_out].lenj = length;
                    out[n_out].score = best_score;
                    ++n_out;
                }
                bpos = bhi + 1;
                found = 1;
                break;
            }
        }
        if (!found)
            ++bpos;
    }
    return n_out;
}

/* Chainer sweep; writes chained HSP indexes into order_out, returns count. */
uint32_t hsp_chain(const HSPc *hsps, uint32_t n, uint32_t *order_out)
{
    if (n == 0)
        return 0;
    /* bendpoints: (pos, is_hi, index), sort by (pos, lo-before-hi), stable */
    typedef struct {
        uint32_t pos;
        uint32_t is_hi;
        uint32_t idx;
    } BP;
    BP *bps = (BP *)malloc(2 * (size_t)n * sizeof(BP));
    for (uint32_t i = 0; i < n; ++i) {
        bps[2 * i].pos = hsps[i].loi;
        bps[2 * i].is_hi = 0;
        bps[2 * i].idx = i;
        bps[2 * i + 1].pos = hsps[i].loi + hsps[i].leni - 1;
        bps[2 * i + 1].is_hi = 1;
        bps[2 * i + 1].idx = i;
    }
    /* insertion sort (stable), n is small */
    for (uint32_t i = 1; i < 2 * n; ++i) {
        BP key = bps[i];
        int32_t j = (int32_t)i - 1;
        while (j >= 0 && (bps[j].pos > key.pos ||
                          (bps[j].pos == key.pos && bps[j].is_hi > key.is_hi))) {
            bps[j + 1] = bps[j];
            --j;
        }
        bps[j + 1] = key;
    }

    float *chain_score = (float *)malloc(n * sizeof(float));
    int32_t *prev_idx = (int32_t *)malloc(n * sizeof(int32_t));
    uint32_t *chains = (uint32_t *)malloc(n * sizeof(uint32_t));
    uint32_t n_chains = 0;

    for (uint32_t bi = 0; bi < 2 * n; ++bi) {
        if (bps[bi].is_hi)
            continue; /* delete-enclosed branch is a no-op in the reference */
        uint32_t idx = bps[bi].idx;
        uint32_t hloi = hsps[idx].loi, hloj = hsps[idx].loj;
        int32_t best = -1;
        float best_score = 0.0f;
        for (uint32_t c = 0; c < n_chains; ++c) {
            uint32_t ci = chains[c];
            uint32_t chii = hsps[ci].loi + hsps[ci].leni - 1;
            uint32_t chij = hsps[ci].loj + hsps[ci].lenj - 1;
            if (chii < hloi && chij < hloj &&
                (best == -1 || chain_score[ci] > best_score)) {
                best = (int32_t)ci;
                best_score = chain_score[ci];
            }
        }
        chains[n_chains++] = idx;
        prev_idx[idx] = best;
        chain_score[idx] = (best == -1) ? hsps[idx].score
                                        : chain_score[best] + hsps[idx].score;
    }

    uint32_t opt = 0;
    float opt_score = chain_score[0];
    for (uint32_t i = 1; i < n; ++i)
        if (chain_score[i] > opt_score) {
            opt = i;
            opt_score = chain_score[i];
        }
    uint32_t len = 0;
    for (int32_t i = (int32_t)opt; i != -1; i = prev_idx[i])
        ++len;
    uint32_t k = len;
    for (int32_t i = (int32_t)opt; i != -1; i = prev_idx[i])
        order_out[--k] = (uint32_t)i;

    free(bps);
    free(chain_score);
    free(prev_idx);
    free(chains);
    return len;
}

/* ---------------- global alignment composition ---------------- */

typedef struct {
    /* scratch reused across calls */
    byte *tb;
    float *mrow;
    float *drow;
    size_t tb_cap;
    size_t row_cap;
    HSPc hsps[512];
    uint32_t order[512];
} AlignScratch;

AlignScratch *scratch_create(void)
{
    return (AlignScratch *)calloc(1, sizeof(AlignScratch));
}

void scratch_destroy(AlignScratch *s)
{
    if (!s)
        return;
    free(s->tb);
    free(s->mrow);
    free(s->drow);
    free(s);
}

static void scratch_alloc(AlignScratch *s, uint32_t la, uint32_t lb)
{
    size_t need_tb = ((size_t)la + 1) * ((size_t)lb + 1);
    if (need_tb > s->tb_cap) {
        free(s->tb);
        s->tb_cap = need_tb + 4096;
        s->tb = (byte *)malloc(s->tb_cap);
    }
    size_t need_row = (size_t)lb + 2;
    if (need_row > s->row_cap) {
        free(s->mrow);
        free(s->drow);
        s->row_cap = need_row + 1024;
        s->mrow = (float *)malloc(s->row_cap * sizeof(float));
        s->drow = (float *)malloc(s->row_cap * sizeof(float));
    }
}

static uint32_t hsp_id_count(const byte *a, const byte *b, const HSPc *h,
                             const byte *match_mx /* 256*256 bool */)
{
    uint32_t cnt = 0;
    for (uint32_t k = 0; k < h->leni; ++k)
        if (match_mx[256 * (size_t)a[h->loi + k] + b[h->loj + k]])
            ++cnt;
    return cnt;
}

static int hsp_is_staggered(const HSPc *h, uint32_t la, uint32_t lb)
{
    int32_t hii = (int32_t)(h->loi + h->leni - 1);
    int32_t hij = (int32_t)(h->loj + h->lenj - 1);
    int32_t tg_la = (int32_t)h->loi - (int32_t)h->loj;
    int32_t tg_lb = (int32_t)h->loj - (int32_t)h->loi;
    int32_t tg_ra = ((int32_t)la - hii - 1) - ((int32_t)lb - hij - 1);
    int32_t tg_rb = ((int32_t)lb - hij - 1) - ((int32_t)la - hii - 1);
    if (tg_la < 0)
        tg_la = 0;
    if (tg_lb < 0)
        tg_lb = 0;
    if (tg_rb < 0)
        tg_rb = 0;
    int32_t gap_a = tg_la + tg_ra;
    int32_t gap_b = tg_lb + tg_rb;
    if (gap_a == 0 || gap_b == 0)
        return 0;
    double r = (la < lb) ? (double)gap_a / la : (double)gap_b / lb;
    return r > 0.5;
}

static void band_diag_range(uint32_t la, uint32_t lb, uint32_t band_radius,
                            uint32_t *dlo, uint32_t *dhi)
{
    uint32_t lo = la < lb ? la : lb;
    uint32_t hi = la > lb ? la : lb;
    if (lo > band_radius)
        lo -= band_radius;
    else
        lo = 1;
    hi += band_radius;
    uint32_t maxdiag = la + lb - 1;
    if (hi > maxdiag)
        hi = maxdiag;
    *dlo = lo;
    *dhi = hi;
}

/* hole DP with terminal-gap adjusted params (AlnParams::Init) */
static int align_hole(AlignScratch *s, const byte *a, uint32_t la,
                      const byte *b, uint32_t lb, uint32_t hloi, uint32_t hloj,
                      uint32_t hleni, uint32_t hlenj, const GapParams *gp,
                      const float *mx, uint32_t band_radius, char *path_out)
{
    if (hleni == 0) {
        memset(path_out, 'I', hlenj);
        path_out[hlenj] = 0;
        return (int)hlenj;
    }
    if (hlenj == 0) {
        memset(path_out, 'D', hleni);
        path_out[hleni] = 0;
        return (int)hleni;
    }
    GapParams lp;
    lp.open_a = gp->open_a;
    lp.open_b = gp->open_b;
    lp.ext_a = gp->ext_a;
    lp.ext_b = gp->ext_b;
    int left_a = hloi == 0, left_b = hloj == 0;
    int right_a = hloi + hleni == la, right_b = hloj + hlenj == lb;
    lp.l_open_a = left_a ? gp->l_open_a : gp->open_a;
    lp.l_ext_a = left_a ? gp->l_ext_a : gp->ext_a;
    lp.l_open_b = left_b ? gp->l_open_b : gp->open_b;
    lp.l_ext_b = left_b ? gp->l_ext_b : gp->ext_b;
    lp.r_open_a = right_a ? gp->r_open_a : gp->open_a;
    lp.r_ext_a = right_a ? gp->r_ext_a : gp->ext_a;
    lp.r_open_b = right_b ? gp->r_open_b : gp->open_b;
    lp.r_ext_b = right_b ? gp->r_ext_b : gp->ext_b;

    scratch_alloc(s, hleni, hlenj);
    float score;
    if (band_radius == 0)
        return nw_full(a + hloi, hleni, b + hloj, hlenj, &lp, mx, s->tb,
                       s->mrow, s->drow, path_out, &score);
    uint32_t dlo, dhi;
    band_diag_range(hleni, hlenj, band_radius, &dlo, &dhi);
    return nw_band(a + hloi, hleni, b + hloj, hlenj, dlo, dhi, &lp, mx,
                   s->tb, s->mrow, s->drow, path_out, &score);
}

/* GlobalAlign_AllOpts. Returns path length (>0), 0 = not aligned,
 * <0 = error.  hf must have set_a/set_b applied. */
/* Chain-only variant for batched device hole alignment: runs the same
 * HSP find + chain + gates as global_align_c but stops before the hole
 * DP, writing the chained HSPs (loi, loj, leni, lenj per row) instead.
 * Returns: -1 = not aligned (fract-id gate / no-chain gate),
 *          -2 = no chain, full-pair banded fallback required,
 *          -3 = full_dp_always set (caller should full-DP),
 *          n >= 0 = chained HSP count (0 never returned; >=1). */
int global_chain_c(HSPFinderC *hf, AlignScratch *s, const byte *match_mx,
                   uint32_t min_global_hsp_length, float min_hsp_fract_id,
                   float min_hsp_score, float xdrop_g, int full_dp_always,
                   int fail_if_no_hsps, uint32_t *hsps_out,
                   float *hsp_fract_id)
{
    const byte *a = hf->a, *b = hf->b;
    uint32_t la = hf->la, lb = hf->lb;

    if (full_dp_always)
        return -3;

    uint32_t min_len = min_global_hsp_length == 0 ? 32 : min_global_hsp_length;
    if (min_len > la / 4)
        min_len = la / 4;
    if (min_len < 16)
        min_len = 16;

    uint32_t n_hsps = hsp_ungapped_blast(hf, xdrop_g, 0, min_len,
                                         min_hsp_score, s->hsps, 512);
    uint32_t n_chain = hsp_chain(s->hsps, n_hsps, s->order);
    for (uint32_t i = 0; i < n_chain; ++i)
        if (hsp_is_staggered(&s->hsps[s->order[i]], la, lb)) {
            n_chain = 0;
            break;
        }
    uint32_t total_len = 0, total_same = 0;
    for (uint32_t i = 0; i < n_chain; ++i) {
        const HSPc *h = &s->hsps[s->order[i]];
        total_len += h->leni;
        total_same += hsp_id_count(a, b, h, match_mx);
    }
    float fract = total_len == 0 ? 0.0f : (float)total_same / total_len;
    *hsp_fract_id = fract;
    if (fract < min_hsp_fract_id && fail_if_no_hsps)
        return -1;
    if (n_chain == 0) {
        if (min_global_hsp_length > 0 && la > 64 && fail_if_no_hsps)
            return -1;
        return -2;
    }
    for (uint32_t i = 0; i < n_chain; ++i) {
        const HSPc *h = &s->hsps[s->order[i]];
        hsps_out[4 * i] = h->loi;
        hsps_out[4 * i + 1] = h->loj;
        hsps_out[4 * i + 2] = h->leni;
        hsps_out[4 * i + 3] = h->lenj;
    }
    return (int)n_chain;
}

int global_align_c(HSPFinderC *hf, AlignScratch *s, const GapParams *gp,
                   const byte *match_mx, uint32_t band_radius,
                   uint32_t min_global_hsp_length, float min_hsp_fract_id,
                   float min_hsp_score, float xdrop_g, int full_dp_always,
                   int fail_if_no_hsps, char *path_out, float *hsp_fract_id)
{
    const byte *a = hf->a, *b = hf->b;
    uint32_t la = hf->la, lb = hf->lb;
    float score;

    if (full_dp_always) {
        scratch_alloc(s, la, lb);
        return nw_full(a, la, b, lb, gp, hf->mx, s->tb, s->mrow, s->drow,
                       path_out, &score);
    }

    uint32_t min_len = min_global_hsp_length == 0 ? 32 : min_global_hsp_length;
    if (min_len > la / 4)
        min_len = la / 4;
    if (min_len < 16)
        min_len = 16;

    uint32_t n_hsps = hsp_ungapped_blast(hf, xdrop_g, 0, min_len,
                                         min_hsp_score, s->hsps, 512);
    uint32_t n_chain = hsp_chain(s->hsps, n_hsps, s->order);
    /* staggered filter */
    for (uint32_t i = 0; i < n_chain; ++i)
        if (hsp_is_staggered(&s->hsps[s->order[i]], la, lb)) {
            n_chain = 0;
            break;
        }
    uint32_t total_len = 0, total_same = 0;
    for (uint32_t i = 0; i < n_chain; ++i) {
        const HSPc *h = &s->hsps[s->order[i]];
        total_len += h->leni;
        total_same += hsp_id_count(a, b, h, match_mx);
    }
    float fract = total_len == 0 ? 0.0f : (float)total_same / total_len;
    *hsp_fract_id = fract;
    if (fract < min_hsp_fract_id && fail_if_no_hsps)
        return 0;
    if (n_chain == 0) {
        if (min_global_hsp_length > 0 && la > 64 && fail_if_no_hsps)
            return 0;
        scratch_alloc(s, la, lb);
        if (band_radius == 0)
            return nw_full(a, la, b, lb, gp, hf->mx, s->tb, s->mrow, s->drow,
                           path_out, &score);
        uint32_t dlo, dhi;
        band_diag_range(la, lb, band_radius, &dlo, &dhi);
        return nw_band(a, la, b, lb, dlo, dhi, gp, hf->mx, s->tb, s->mrow,
                       s->drow, path_out, &score);
    }

    char *p = path_out;
    uint32_t prev_hii = 0, prev_hij = 0;
    int have_prev = 0;
    for (uint32_t i = 0; i < n_chain; ++i) {
        const HSPc *h = &s->hsps[s->order[i]];
        uint32_t hloi, hloj, hleni, hlenj;
        if (!have_prev) {
            hloi = 0;
            hloj = 0;
            hleni = h->loi;
            hlenj = h->loj;
        } else {
            hloi = prev_hii + 1;
            hloj = prev_hij + 1;
            hleni = h->loi - prev_hii - 1;
            hlenj = h->loj - prev_hij - 1;
        }
        int n = align_hole(s, a, la, b, lb, hloi, hloj, hleni, hlenj, gp,
                           hf->mx, band_radius, p);
        if (n < 0)
            return n;
        p += n;
        memset(p, 'M', h->leni);
        p += h->leni;
        prev_hii = h->loi + h->leni - 1;
        prev_hij = h->loj + h->lenj - 1;
        have_prev = 1;
    }
    {
        uint32_t hloi = prev_hii + 1;
        uint32_t hloj = prev_hij + 1;
        int n = align_hole(s, a, la, b, lb, hloi, hloj, la - hloi, lb - hloj,
                           gp, hf->mx, band_radius, p);
        if (n < 0)
            return n;
        p += n;
    }
    *p = 0;
    return (int)(p - path_out);
}

/* ---------------- gapped x-drop local alignment ----------------
 * Exact semantics of the reference forward x-drop DP with adaptive band
 * (src/xdropfwdmem.cpp:344-749), backward via sequence reversal
 * (src/xdropbwdmem.cpp), and the O(sqrt)-memory split drivers
 * (src/xdropfwdsplit.cpp, g_MaxL=4096 from src/xdpmem.h:6).
 */

#define XD_MAXL 4096

typedef struct {
    float *mrow_buf;   /* size cap+2, mrow = buf+1 so mrow[-1] valid */
    float *drow;       /* size cap+2 */
    byte *tb;          /* (cap+1)*(cap+1) adaptive; allocated on demand */
    size_t tb_cap;
    size_t row_cap;
    byte *rev_a;
    byte *rev_b;
    size_t rev_cap;
    char *path1;
    char *path2;
    size_t path_cap;
} XDScratch;

XDScratch *xd_create(void)
{
    return (XDScratch *)calloc(1, sizeof(XDScratch));
}

void xd_destroy(XDScratch *s)
{
    if (!s)
        return;
    free(s->mrow_buf);
    free(s->drow);
    free(s->tb);
    free(s->rev_a);
    free(s->rev_b);
    free(s->path1);
    free(s->path2);
    free(s);
}

static void xd_alloc(XDScratch *s, uint32_t la, uint32_t lb)
{
    size_t need_row = (size_t)lb + 3;
    if (need_row > s->row_cap) {
        free(s->mrow_buf);
        free(s->drow);
        s->row_cap = need_row + 1024;
        s->mrow_buf = (float *)malloc(s->row_cap * sizeof(float));
        s->drow = (float *)malloc(s->row_cap * sizeof(float));
    }
    size_t need_tb = ((size_t)la + 2) * ((size_t)lb + 2);
    if (need_tb > s->tb_cap) {
        free(s->tb);
        s->tb_cap = need_tb + 4096;
        s->tb = (byte *)malloc(s->tb_cap);
    }
    size_t need_rev = (size_t)(la > lb ? la : lb) + 2;
    if (need_rev > s->rev_cap) {
        free(s->rev_a);
        free(s->rev_b);
        s->rev_cap = need_rev + 1024;
        s->rev_a = (byte *)malloc(s->rev_cap);
        s->rev_b = (byte *)malloc(s->rev_cap);
    }
    size_t need_path = (size_t)la + lb + 16;
    if (need_path > s->path_cap) {
        free(s->path1);
        free(s->path2);
        s->path_cap = 2 * need_path + 4096;
        s->path1 = (char *)malloc(s->path_cap);
        s->path2 = (char *)malloc(s->path_cap);
    }
}

/* Grow only the path buffers (path1/path2); used by the split/align
 * drivers so the captured pointers survive inner xd_alloc calls, without
 * forcing the O(la*lb) traceback allocation for huge sequences. */
static void xd_alloc_path(XDScratch *s, uint32_t la, uint32_t lb)
{
    size_t need_path = (size_t)la + lb + 16;
    if (need_path > s->path_cap) {
        free(s->path1);
        free(s->path2);
        s->path_cap = 2 * need_path + 4096;
        s->path1 = (char *)malloc(s->path_cap);
        s->path2 = (char *)malloc(s->path_cap);
    }
}

static uint32_t umin(uint32_t a, uint32_t b) { return a < b ? a : b; }
static uint32_t umax(uint32_t a, uint32_t b) { return a > b ? a : b; }

/* Forward x-drop; path written to path_out (null-terminated).  Returns
 * score; 0 score means empty alignment. */
float xdrop_fwd(XDScratch *s, const byte *A, uint32_t la, const byte *B,
                uint32_t lb, float open_p, float ext_p, const float *mx,
                float x, uint32_t *leni, uint32_t *lenj, char *path_out)
{
    if (la == 1 || lb == 1) {
        *leni = 1;
        *lenj = 1;
        path_out[0] = 'M';
        path_out[1] = 0;
        return mx[256 * (size_t)A[0] + B[0]];
    }
    xd_alloc(s, la, lb);
    const float abs_open = -open_p;
    const float abs_ext = -ext_p;
    float *mrow = s->mrow_buf + 1;
    float *drow = s->drow;
    byte *tb = s->tb;
    size_t stride = (size_t)lb + 2;

    mrow[-1] = NEG_INF;
    drow[0] = NEG_INF;
    drow[1] = NEG_INF;

    float best_score = mx[256 * (size_t)A[0] + B[0]];
    uint32_t besti = 0, bestj = 0;
    uint32_t prev_jlo = 0, prev_jhi = 0;
    uint32_t jlo = 1, jhi = 1;
    float m0 = best_score;

    for (uint32_t i = 1; i < la; ++i) {
        if (jlo == prev_jlo) {
            mrow[(int32_t)jlo - 1] = NEG_INF;
            drow[jlo] = NEG_INF;
        }
        uint32_t endj = umin(prev_jhi + 1, lb);
        for (uint32_t j = endj + 1; j <= umin(jhi + 1, lb); ++j) {
            mrow[j - 1] = NEG_INF;
            drow[j] = NEG_INF;
        }

        uint32_t next_jlo = 0xFFFFFFFFu;
        uint32_t next_jhi = 0xFFFFFFFFu;
        const float *mx_row = mx + 256 * (size_t)A[i];
        float i0 = NEG_INF;
        byte *tbrow = tb + stride * i;
        float saved_m0;

        for (uint32_t j = jlo; j <= jhi; ++j) {
            byte b = B[j];
            byte bits = 0;
            saved_m0 = m0;
            /* MATCH */
            {
                float xm = m0;
                if (drow[j] > xm) {
                    xm = drow[j];
                    bits = TB_DM;
                }
                if (i0 > xm) {
                    xm = i0;
                    bits = TB_IM;
                }
                m0 = mrow[j];
                float sc = xm + mx_row[b];
                mrow[j] = sc;
                float h = sc - best_score + x;
                if (h > 0) {
                    next_jlo = umin(next_jlo, j + 1);
                    next_jhi = j + 1;
                }
                if (h > abs_open)
                    next_jlo = umin(next_jlo, j);
                if (h > abs_ext && j == jhi && jhi + 1 < lb) {
                    ++jhi;
                    uint32_t new_endj = umin(jhi + 1, lb);
                    new_endj = umax(new_endj, endj);
                    for (uint32_t j2 = endj + 1; j2 <= new_endj; ++j2) {
                        if (j2 - 1 > j)
                            mrow[j2 - 1] = NEG_INF;
                        drow[j2] = NEG_INF;
                    }
                    endj = new_endj;
                }
                if (sc >= best_score) {
                    best_score = sc;
                    besti = i;
                    bestj = j;
                }
            }
            /* DELETE */
            if (j != jlo) {
                float md = saved_m0 + open_p;
                drow[j] += ext_p;
                if (md >= drow[j]) {
                    drow[j] = md;
                    bits |= TB_MD;
                }
                float h = drow[j] - best_score + x;
                if (h > 0) {
                    next_jlo = umin(next_jlo, j - 1);
                    next_jhi = umax(next_jhi, j - 1);
                }
            }
            /* INSERT */
            {
                float mi = saved_m0 + open_p;
                i0 += ext_p;
                if (mi >= i0) {
                    i0 = mi;
                    bits |= TB_MI;
                }
                float h = i0 - best_score + x;
                if (h > 0) {
                    next_jlo = umin(next_jlo, j + 1);
                    next_jhi = j + 1;
                }
                if (h > abs_ext && j == jhi && jhi + 1 < lb) {
                    ++jhi;
                    uint32_t new_endj = umin(jhi + 1, lb);
                    new_endj = umax(new_endj, endj);
                    for (uint32_t j2 = endj + 1; j2 <= new_endj; ++j2) {
                        mrow[j2 - 1] = NEG_INF;
                        drow[j2] = NEG_INF;
                    }
                    endj = new_endj;
                }
            }
            tbrow[j] = bits;
        }

        /* special case for end of Drow */
        if (jhi < lb) {
            uint32_t jhi1 = jhi + 1;
            tbrow[jhi1] = 0;
            float md = m0 + open_p;
            drow[jhi1] += ext_p;
            if (md >= drow[jhi1]) {
                drow[jhi1] = md;
                tbrow[jhi1] = TB_MD;
            }
        }

        if (next_jlo == 0xFFFFFFFFu)
            break;
        prev_jlo = jlo;
        prev_jhi = jhi;
        jlo = next_jlo;
        jhi = next_jhi;
        if (jlo >= lb)
            jlo = lb - 1;
        if (jhi >= lb)
            jhi = lb - 1;
        if (jlo == prev_jlo) {
            m0 = NEG_INF;
            drow[jlo] = NEG_INF;
        } else {
            m0 = mrow[(int32_t)jlo - 1];
        }
    }

    if (best_score <= 0.0f) {
        *leni = 0;
        *lenj = 0;
        path_out[0] = 0;
        return 0.0f;
    }

    /* traceback: M reads tb[i][j]; D reads tb[i][j+1]; I reads tb[i+1][j] */
    {
        size_t pos = 0;
        uint32_t i = besti, j = bestj;
        char st = 'M';
        for (;;) {
            path_out[pos++] = st;
            if (i == 0 && j == 0)
                break;
            char next;
            if (st == 'M') {
                byte c = tb[stride * i + j];
                next = (c & TB_DM) ? 'D' : ((c & TB_IM) ? 'I' : 'M');
                --i;
                --j;
            } else if (st == 'D') {
                byte c = tb[stride * i + (j + 1)];
                next = (c & TB_MD) ? 'M' : 'D';
                --i;
            } else {
                byte c = tb[stride * (i + 1) + j];
                next = (c & TB_MI) ? 'M' : 'I';
                --j;
            }
            st = next;
        }
        for (size_t k = 0; k < pos / 2; ++k) {
            char t = path_out[k];
            path_out[k] = path_out[pos - 1 - k];
            path_out[pos - 1 - k] = t;
        }
        path_out[pos] = 0;
    }
    *leni = besti + 1;
    *lenj = bestj + 1;
    return best_score;
}

float xdrop_bwd(XDScratch *s, const byte *A, uint32_t la, const byte *B,
                uint32_t lb, float open_p, float ext_p, const float *mx,
                float x, uint32_t *leni, uint32_t *lenj, char *path_out)
{
    xd_alloc(s, la, lb);
    for (uint32_t i = 0; i < la; ++i)
        s->rev_a[i] = A[la - i - 1];
    for (uint32_t i = 0; i < lb; ++i)
        s->rev_b[i] = B[lb - i - 1];
    float score = xdrop_fwd(s, s->rev_a, la, s->rev_b, lb, open_p, ext_p,
                            mx, x, leni, lenj, path_out);
    if (score <= 0.0f)
        return score;
    size_t n = strlen(path_out);
    for (size_t k = 0; k < n / 2; ++k) {
        char t = path_out[k];
        path_out[k] = path_out[n - 1 - k];
        path_out[n - 1 - k] = t;
    }
    return score;
}

static uint32_t xd_subl(uint32_t L)
{
    if (L <= XD_MAXL)
        return L;
    if (L < 2 * XD_MAXL)
        return L / 2;
    return XD_MAXL;
}

static float xdrop_split(XDScratch *s, const byte *A, uint32_t la,
                         const byte *B, uint32_t lb, float open_p,
                         float ext_p, const float *mx, float x, int bwd,
                         uint32_t *leni, uint32_t *lenj, char *path_out)
{
    /* XDropFwdSplit (src/xdropfwdsplit.cpp:24-97); bwd variant applies the
     * same loop to reversed sequences and reverses the path. */
    const byte *a = A;
    const byte *b = B;
    byte *ra = 0, *rb = 0;
    if (bwd) {
        ra = (byte *)malloc(la);
        rb = (byte *)malloc(lb);
        for (uint32_t i = 0; i < la; ++i)
            ra[i] = A[la - i - 1];
        for (uint32_t i = 0; i < lb; ++i)
            rb[i] = B[lb - i - 1];
        a = ra;
        b = rb;
    }
    uint32_t li = 0, lj = 0;
    float sum = 0.0f;
    xd_alloc_path(s, la, lb);
    char *sub = s->path2;
    size_t pos = 0;
    for (;;) {
        if (li == la || lj == lb)
            break;
        uint32_t sub_la = xd_subl(la - li);
        uint32_t sub_lb = xd_subl(lb - lj);
        uint32_t sli, slj;
        float score = xdrop_fwd(s, a + li, sub_la, b + lj, sub_lb, open_p,
                                ext_p, mx, x, &sli, &slj, sub);
        if (score == 0.0f)
            break;
        sum += score;
        li += sli;
        lj += slj;
        size_t n = strlen(sub);
        memcpy(path_out + pos, sub, n);
        pos += n;
        if (sli < sub_la && slj < sub_lb)
            break;
    }
    path_out[pos] = 0;
    if (bwd) {
        for (size_t k = 0; k < pos / 2; ++k) {
            char t = path_out[k];
            path_out[k] = path_out[pos - 1 - k];
            path_out[pos - 1 - k] = t;
        }
        free(ra);
        free(rb);
    }
    *leni = li;
    *lenj = lj;
    return sum;
}

/* XDropAlignMem (src/xdropalignmem.cpp:26-244): bwd from anchor start,
 * fwd from anchor end, splice with anchor Ms, subtract duplicated anchor
 * end columns.  Writes HSP coords + path. */
float xdrop_align(XDScratch *s, const byte *A, uint32_t la, const byte *B,
                  uint32_t lb, uint32_t anc_loi, uint32_t anc_loj,
                  uint32_t anc_len, float open_p, float ext_p,
                  const float *mx, float x, uint32_t *hsp_out /*4*/,
                  char *path_out)
{
    if (anc_len <= 1) {
        path_out[0] = 0;
        return 0.0f;
    }
    /* Pre-size the path buffers for the full problem so the path1/path2
     * pointers captured below cannot be reallocated by inner xd_alloc
     * calls (every sub-problem is <= (la, lb)). */
    xd_alloc_path(s, la, lb);
    uint32_t anc_hii = anc_loi + anc_len - 1;
    uint32_t anc_hij = anc_loj + anc_len - 1;
    const byte *fwd_a = A + anc_hii;
    const byte *fwd_b = B + anc_hij;
    uint32_t fwd_la = la - anc_hii;
    uint32_t fwd_lb = lb - anc_hij;

    uint32_t bwd_leni, bwd_lenj;
    float bwd_score;
    char *bwd_path = s->path1;
    if (anc_loi > XD_MAXL || anc_loj > XD_MAXL)
        bwd_score = xdrop_split(s, A, anc_loi + 1, B, anc_loj + 1, open_p,
                                ext_p, mx, x, 1, &bwd_leni, &bwd_lenj,
                                bwd_path);
    else
        bwd_score = xdrop_bwd(s, A, anc_loi + 1, B, anc_loj + 1, open_p,
                              ext_p, mx, x, &bwd_leni, &bwd_lenj, bwd_path);

    size_t pos = strlen(bwd_path);
    memcpy(path_out, bwd_path, pos);

    memset(path_out + pos, 'M', anc_len - 2);
    pos += anc_len - 2;

    uint32_t fwd_leni, fwd_lenj;
    float fwd_score;
    char *fwd_path = s->path1;
    if (fwd_la > XD_MAXL || fwd_lb > XD_MAXL)
        fwd_score = xdrop_split(s, fwd_a, fwd_la, fwd_b, fwd_lb, open_p,
                                ext_p, mx, x, 0, &fwd_leni, &fwd_lenj,
                                fwd_path);
    else
        fwd_score = xdrop_fwd(s, fwd_a, fwd_la, fwd_b, fwd_lb, open_p,
                              ext_p, mx, x, &fwd_leni, &fwd_lenj, fwd_path);
    size_t n = strlen(fwd_path);
    memcpy(path_out + pos, fwd_path, n);
    pos += n;
    path_out[pos] = 0;

    float anc_score = 0.0f;
    for (uint32_t k = 0; k < anc_len; ++k)
        anc_score += mx[256 * (size_t)A[anc_loi + k] + B[anc_loj + k]];
    float dupe = mx[256 * (size_t)A[anc_loi] + B[anc_loj]];
    if (anc_len > 1)
        dupe += mx[256 * (size_t)A[anc_hii] + B[anc_hij]];

    float score = bwd_score + fwd_score + anc_score - dupe;
    hsp_out[0] = anc_loi + 1 - bwd_leni;             /* Loi */
    hsp_out[1] = anc_loj + 1 - bwd_lenj;             /* Loj */
    hsp_out[2] = bwd_leni + fwd_leni + anc_len - 2;  /* Leni */
    hsp_out[3] = bwd_lenj + fwd_lenj + anc_len - 2;  /* Lenj */
    return score;
}

/* LocalAligner::AlignPos (src/localaligner.cpp:101-211): ungapped x-drop
 * both ways from seed, anchor selection, gapped x-drop, E-value gate.
 * Returns 1 with outputs filled, 0 = rejected. */
int local_align_pos(XDScratch *s, const byte *Q, uint32_t ql, const byte *T,
                    uint32_t tl, uint32_t qpos, uint32_t tpos,
                    const float *mx, float xdrop_u, float xdrop_g,
                    float open_p, float ext_p, float min_ungapped_score,
                    double gapped_lambda, double log_gapped_k,
                    double db_size, double max_evalue,
                    uint32_t *hsp_out /*4*/, float *score_out,
                    double *evalue_out, char *path_out)
{
    /* ungapped extend left */
    float left_score = 0.0f, left_total = 0.0f;
    uint32_t left_len = 0, k = 0;
    int32_t i = (int32_t)qpos, j = (int32_t)tpos;
    while (i >= 0 && j >= 0) {
        ++k;
        left_total += mx[256 * (size_t)Q[i] + T[j]];
        if (left_total > left_score) {
            left_score = left_total;
            left_len = k;
        } else if (left_score - left_total > xdrop_u)
            break;
        --i;
        --j;
    }
    /* ungapped extend right */
    float right_score = 0.0f, right_total = 0.0f;
    uint32_t right_len = 0;
    i = (int32_t)qpos + 1;
    j = (int32_t)tpos + 1;
    k = 0;
    while (i < (int32_t)ql && j < (int32_t)tl) {
        ++k;
        right_total += mx[256 * (size_t)Q[i] + T[j]];
        if (right_total > right_score) {
            right_score = right_total;
            right_len = k;
        } else if (right_score - right_total > xdrop_u)
            break;
        ++i;
        ++j;
    }
    float score = left_score + right_score;
    if (score < min_ungapped_score)
        return 0;

    /* anchor (best positive run, same as HSPFinder::GetAnchor) */
    uint32_t loi = qpos + 1 - left_len;
    uint32_t loj = tpos + 1 - left_len;
    uint32_t seg_len = left_len + right_len;
    uint32_t startk = 0xFFFFFFFFu, best_startk = 0xFFFFFFFFu, length = 0;
    float anc = 0.0f, best = 0.0f;
    uint32_t ii = loi, jj = loj;
    for (uint32_t kk = 0; kk < seg_len; ++kk) {
        float sc = mx[256 * (size_t)Q[ii++] + T[jj++]];
        if (sc > 0) {
            if (startk == 0xFFFFFFFFu) {
                startk = kk;
                anc = sc;
            } else
                anc += sc;
        } else {
            if (anc > best) {
                best = anc;
                best_startk = startk;
                length = kk - startk;
            }
            startk = 0xFFFFFFFFu;
        }
    }
    if (anc > best) {
        best = anc;
        best_startk = startk;
        length = seg_len - startk;
    }
    if (best <= 0.0f)
        return 0;
    uint32_t anc_loi = loi + best_startk;
    uint32_t anc_loj = loj + best_startk;

    float gapped = xdrop_align(s, Q, ql, T, tl, anc_loi, anc_loj, length,
                               open_p, ext_p, mx, xdrop_g, hsp_out,
                               path_out);
    if (gapped <= 0.0f)
        return 0;
    double bit = ((double)gapped * gapped_lambda - log_gapped_k)
        / 0.69314718055994530942;
    double evalue = ((double)ql * db_size) / pow(2.0, bit);
    if (evalue > max_evalue)
        return 0;
    *score_out = gapped;
    *evalue_out = evalue;
    return 1;
}

/* ---------------------------------------------------------------------------
 * USORT candidate ranking (semantics of search/usorted.py, i.e. usearch12
 * src/udbusortedsearcher.cpp SetU_NonCoded:375-410 + SetTopBump:230-267 and
 * src/countsort.cpp CountSortOrderDesc).
 *
 * One RankScratch per (ranker, index) pair: reusable U array, per-word seen
 * bitmap, touched-target list and output staging.  The postings view is the
 * three-tier LSM layout of index/udb.py: a CSR base plus up to two
 * word-sorted (word, tix) runs.
 * ------------------------------------------------------------------------- */

typedef struct {
    uint32_t *u;          /* per-target shared-word counts */
    uint32_t u_cap;
    int32_t *touched;     /* first-touch target list (for clearing u) */
    uint32_t touched_cap;
    uint8_t *seen;        /* per-word bitmap */
    int64_t seen_cap;     /* in bits */
    int64_t *uw;          /* unique query words */
    uint32_t uw_cap;
    uint32_t *hist;       /* counting-sort histogram */
    uint32_t hist_cap;
    uint32_t *stage_tix;  /* placement staging (n_emit copied back) */
    uint32_t *stage_cnt;
    /* big-DB mode (usearch12 src/udbusortedsearcherbig.cpp): armed by
     * rank_scratch_set_big; mode-0 ranks switch semantics when
     * seq_count > big_threshold (OPT_big, default 100000) */
    int big_set;
    float big_min_fract_id;   /* OPT_id as float (m_MinFractId) */
    int big_is_nucleo;
    uint32_t big_stepwords;   /* OPT_stepwords (default 8) */
    uint32_t big_db_step;     /* UDBParams m_DBStep (default 1) */
    uint32_t big_threshold;   /* OPT_big */
} RankScratch;

RankScratch *rank_scratch_create(void)
{
    RankScratch *s = (RankScratch *)calloc(1, sizeof(RankScratch));
    s->big_threshold = 100000;
    return s;
}

void rank_scratch_set_big(RankScratch *s, float min_fract_id,
                          int is_nucleo, uint32_t stepwords,
                          uint32_t db_step, uint32_t threshold)
{
    s->big_set = 1;
    s->big_min_fract_id = min_fract_id;
    s->big_is_nucleo = is_nucleo;
    s->big_stepwords = stepwords;
    s->big_db_step = db_step ? db_step : 1;
    s->big_threshold = threshold;
}

/* GetMinWordCount (src/wordparams.cpp:60-167): CD-HIT minimum shared
 * unique word count for a given fractional identity. */
static const double MIN_WORD_FRACT_AMINO[50] = {
    0.00, 0.00, 0.00, 0.00, 0.01, 0.01, 0.01, 0.02, 0.02, 0.02,
    0.03, 0.04, 0.04, 0.05, 0.06, 0.06, 0.08, 0.08, 0.10, 0.10,
    0.11, 0.14, 0.14, 0.14, 0.17, 0.17, 0.18, 0.20, 0.21, 0.21,
    0.27, 0.28, 0.31, 0.34, 0.36, 0.41, 0.43, 0.45, 0.48, 0.54,
    0.55, 0.56, 0.64, 0.69, 0.73, 0.75, 0.80, 0.85, 0.90, 0.95,
};

static uint32_t get_min_word_count(uint32_t nuw, double fract_id,
                                   uint32_t word_ones, int is_nucleo)
{
    if (is_nucleo) {
        /* GetMinWordCount2 (src/wordparams.cpp:152-162) */
        double wf = 1.0 - (1.0 - fract_id) * word_ones;
        if (wf < 0.0)
            return 1;
        wf *= nuw;
        if (wf < 1.0)
            return 1;
        return (uint32_t)wf;
    }
    if (fract_id < 0.5)
        return 0;
    unsigned i = (unsigned)((fract_id - 0.5) * 100);
    if (i >= 50)
        i = 49;
    return (uint32_t)(MIN_WORD_FRACT_AMINO[i] * nuw);
}

/* GetWordCountingParams (src/wordparams.cpp:168-193): query-word step
 * for big-DB ranking.  MinU is computed by the reference but unused by
 * UDBSearchBig, so only Step is returned here. */
static uint32_t big_query_step(const RankScratch *s, uint32_t nuw,
                               uint32_t word_ones)
{
    uint32_t nuw_eff = nuw / s->big_db_step;
    uint32_t thresh = get_min_word_count(
        nuw_eff, (double)s->big_min_fract_id, word_ones,
        s->big_is_nucleo);
    if (s->big_stepwords == 0)
        return 1;
    uint32_t step = thresh / s->big_stepwords;
    return step ? step : 1;
}

void rank_scratch_destroy(RankScratch *s)
{
    if (!s) return;
    free(s->u); free(s->touched); free(s->seen); free(s->uw); free(s->hist);
    free(s->stage_tix); free(s->stage_cnt);
    free(s);
}

static void rank_alloc(RankScratch *s, uint32_t seq_count, int64_t slot_count,
                       uint32_t max_words)
{
    if (seq_count > s->u_cap) {
        uint32_t cap = seq_count * 2 + 1024;
        free(s->u);
        s->u = (uint32_t *)calloc(cap, sizeof(uint32_t));
        free(s->touched);
        s->touched = (int32_t *)malloc(cap * sizeof(int32_t));
        free(s->stage_tix);
        free(s->stage_cnt);
        s->stage_tix = (uint32_t *)malloc(cap * sizeof(uint32_t));
        s->stage_cnt = (uint32_t *)malloc(cap * sizeof(uint32_t));
        s->u_cap = cap;
        s->touched_cap = cap;
    }
    if (s->hist_cap < 65536) {
        free(s->hist);
        s->hist_cap = 65536;
        s->hist = (uint32_t *)calloc(s->hist_cap, sizeof(uint32_t));
    }
    int64_t bits = slot_count;
    if (bits > s->seen_cap) {
        free(s->seen);
        s->seen = (uint8_t *)calloc((size_t)((bits + 7) / 8), 1);
        s->seen_cap = bits;
    }
    if (max_words > s->uw_cap) {
        uint32_t cap = max_words * 2 + 64;
        free(s->uw);
        s->uw = (int64_t *)malloc(cap * sizeof(int64_t));
        s->uw_cap = cap;
    }
}

/* first index in w[0..n) with w[i] >= key (lower bound) */
static int64_t lower_bound64(const int64_t *w, int64_t n, int64_t key)
{
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (w[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

/* Ranked USORT candidates.
 * mode 0: SetTopBump(min_u=1, bump_pct) + CountSortOrderDesc   (rank())
 * mode 1: no bump (keep all u>=1)       + CountSortOrderDesc   (GetU)
 * Returns candidate count; out_tix/out_counts caller-allocated with
 * capacity seq_count. */
/* bulk ;size=N label annotation parse (io/seqdb.py size_from_label
 * semantics: first ";size=" followed by at least one digit; `default`
 * otherwise).  Labels are (lo, hi) byte ranges into raw. */
void sizes_from_labels_c(const uint8_t *raw, const int64_t *lo,
                         const int64_t *hi, int64_t n, int64_t dflt,
                         int64_t *out)
{
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t *p = raw + lo[i];
        int64_t len = hi[i] - lo[i];
        int64_t v = dflt;
        for (int64_t k = 0; k + 6 <= len; ++k) {
            if (p[k] == ';' && p[k + 1] == 's' && p[k + 2] == 'i'
                && p[k + 3] == 'z' && p[k + 4] == 'e' && p[k + 5] == '=') {
                int64_t j = k + 6;
                if (j < len && p[j] >= '0' && p[j] <= '9') {
                    uint64_t acc = 0;
                    while (j < len && p[j] >= '0' && p[j] <= '9') {
                        if (acc < (1ull << 62))
                            acc = acc * 10u + (uint64_t)(p[j] - '0');
                        ++j;
                    }
                    v = (int64_t)acc;   /* saturating: ordering-safe */
                    break;
                }
                /* ";size=" without digits: the regex keeps searching */
            }
        }
        out[i] = v;
    }
}

/* QuickSortOrderRecurse (src/sort.h:62-101): Hoare partition around
 * the middle element — identical swap sequence to the Python
 * implementation in search/hitmgr.py, hence identical tie ordering. */
static void qsort_order_rec(const double *v, int64_t *ord, int64_t left,
                            int64_t right, int desc)
{
    int64_t i = left, j = right;
    double pivot = v[ord[(left + right) / 2]];
    while (i <= j) {
        if (desc) {
            while (v[ord[i]] > pivot) ++i;
            while (v[ord[j]] < pivot) --j;
        } else {
            while (v[ord[i]] < pivot) ++i;
            while (v[ord[j]] > pivot) --j;
        }
        if (i <= j) {
            int64_t t = ord[i]; ord[i] = ord[j]; ord[j] = t;
            ++i; --j;
        }
    }
    if (left < j) qsort_order_rec(v, ord, left, j, desc);
    if (i < right) qsort_order_rec(v, ord, i, right, desc);
}

void quick_sort_order_c(const double *v, int64_t n, int desc,
                        int64_t *ord)
{
    for (int64_t k = 0; k < n; ++k)
        ord[k] = k;
    if (n > 1)
        qsort_order_rec(v, ord, 0, n - 1, desc);
}

int64_t usort_rank_c(
    RankScratch *s,
    const uint8_t *seq, uint32_t L,
    const uint8_t *char_to_letter,   /* 256; 0xFF = invalid (incl. masked) */
    uint32_t alpha_size, uint32_t wlen, int64_t slot_count,
    const int64_t *starts, const int32_t *postings, int has_csr,
    const int64_t *sw, const int32_t *st, int64_t n_sorted,
    const int64_t *pw, const int32_t *pt, int64_t n_pending,
    uint32_t seq_count,
    uint32_t bump_pct, int mode, int64_t max_emit,
    uint32_t *out_tix, uint32_t *out_counts)
{
    if (seq_count == 0 || L < wlen)
        return 0;
    rank_alloc(s, seq_count, slot_count, L);

    /* -- query unique words (SetQueryUniqueWords) -- */
    int64_t pow_w = 1;
    for (uint32_t k = 1; k < wlen; ++k) pow_w *= alpha_size;
    uint32_t nuw = 0;
    int64_t word = 0;
    uint32_t run = 0;
    for (uint32_t i = 0; i < L; ++i) {
        uint8_t let = char_to_letter[seq[i]];
        if (let == 0xFF) { run = 0; word = 0; continue; }
        if (run >= wlen) word = (pow_w & (pow_w - 1)) == 0
                ? (word & (pow_w - 1))        /* 4^k alphabet */
                : word - (word / pow_w) * pow_w; /* drop high digit */
        word = word * alpha_size + let;
        if (++run >= wlen) {
            if (!(s->seen[word >> 3] & (1u << (word & 7)))) {
                s->seen[word >> 3] |= (uint8_t)(1u << (word & 7));
                s->uw[nuw++] = word;
            }
        }
    }
    /* -- big-DB mode (src/udbusortedsearcher.cpp:41-57 latch +
     * src/udbusortedsearcherbig.cpp UDBSearchBig): above OPT_big
     * targets the reference switches semantics entirely — every
     * big_query_step'th unique query word is counted, there is NO
     * SetTopBump, candidates keep FIRST-TOUCH order for ties, and
     * CountSortSubsetDesc truncates below NextValue/2 where NextValue
     * carries the traversal-order running-max quirk. -- */
    if (mode == 0 && s->big_set && seq_count > s->big_threshold) {
        uint32_t step = big_query_step(s, nuw, wlen);
        uint32_t *u = s->u;
        int32_t *touched = s->touched;
        uint32_t nt = 0;
        for (uint32_t k = 0; k < nuw; k += step) {
            int64_t w = s->uw[k];
            if (has_csr == 2) {
                const uint16_t *p16 = (const uint16_t *)postings;
                if (k + 4 * step < nuw)
                    __builtin_prefetch(&starts[s->uw[k + 4 * step]], 0, 1);
                if (k + 2 * step < nuw)
                    __builtin_prefetch(&p16[starts[s->uw[k + 2 * step]]],
                                       0, 1);
                int64_t lo = starts[w], hi = starts[w + 1];
                for (int64_t p = lo; p < hi; ++p) {
                    uint32_t t = p16[p];
                    if (t < seq_count) {
                        if (u[t]++ == 0) touched[nt++] = (int32_t)t;
                    }
                }
            } else if (has_csr) {
                if (k + 4 * step < nuw)
                    __builtin_prefetch(&starts[s->uw[k + 4 * step]], 0, 1);
                if (k + 2 * step < nuw)
                    __builtin_prefetch(&postings[starts[s->uw[k + 2 * step]]],
                                       0, 1);
                int64_t lo = starts[w], hi = starts[w + 1];
                for (int64_t p = lo; p < hi; ++p) {
                    int32_t t = postings[p];
                    if ((uint32_t)t < seq_count) {
                        if (u[t]++ == 0) touched[nt++] = t;
                    }
                }
            }
            if (n_sorted) {
                int64_t lo = lower_bound64(sw, n_sorted, w);
                int64_t hi = lower_bound64(sw, n_sorted, w + 1);
                for (int64_t p = lo; p < hi; ++p) {
                    int32_t t = st[p];
                    if ((uint32_t)t < seq_count) {
                        if (u[t]++ == 0) touched[nt++] = t;
                    }
                }
            }
        }
        if (n_pending) {
            /* pending tier: membership against the STEPPED word subset */
            for (uint32_t k = 0; k < nuw; ++k)
                s->seen[s->uw[k] >> 3] = 0;
            for (uint32_t k = 0; k < nuw; k += step) {
                int64_t w = s->uw[k];
                s->seen[w >> 3] |= (uint8_t)(1u << (w & 7));
            }
            for (int64_t p = 0; p < n_pending; ++p) {
                int64_t w = pw[p];
                if (s->seen[w >> 3] & (1u << (w & 7))) {
                    int32_t t = pt[p];
                    if ((uint32_t)t < seq_count) {
                        if (u[t]++ == 0) touched[nt++] = t;
                    }
                }
            }
            for (uint32_t k = 0; k < nuw; k += step)
                s->seen[s->uw[k] >> 3] = 0;
        } else {
            for (uint32_t k = 0; k < nuw; ++k)
                s->seen[s->uw[k] >> 3] = 0;
        }
        if (nt == 0)
            return 0;
        /* CountSortSubsetDesc (src/countsort.cpp:110-192) */
        uint32_t maxv = 0, nextv = 0;
        uint32_t *hist = s->hist;
        for (uint32_t i = 0; i < nt; ++i) {
            uint32_t v = u[touched[i]];
            if (v > maxv) { nextv = maxv; maxv = v; }
        }
        uint32_t minv = nextv / 2;
        for (uint32_t i = 0; i < nt; ++i) {
            uint32_t v = u[touched[i]];
            if (v >= minv)
                ++hist[v];
        }
        uint32_t c_star = minv;
        uint32_t n_emit = 0;
        for (int64_t v = maxv; v >= (int64_t)minv; --v) {
            n_emit += hist[v];
            c_star = (uint32_t)v;
            if (max_emit > 0 && n_emit >= (uint32_t)max_emit)
                break;
        }
        uint32_t off = 0;
        for (int64_t v = maxv; v >= (int64_t)c_star; --v) {
            uint32_t c = hist[v];
            hist[v] = off;
            off += c;
        }
        n_emit = off;
        uint32_t *stix = s->stage_tix, *scnt = s->stage_cnt;
        for (uint32_t i = 0; i < nt; ++i) {
            uint32_t t = (uint32_t)touched[i];
            uint32_t v = u[t];
            if (v < c_star) continue;
            uint32_t pos = hist[v]++;
            stix[pos] = t;
            scnt[pos] = v;
        }
        memcpy(out_tix, stix, n_emit * sizeof(uint32_t));
        memcpy(out_counts, scnt, n_emit * sizeof(uint32_t));
        memset(hist, 0, (maxv + 1) * sizeof(uint32_t));
        for (uint32_t i = 0; i < nt; ++i)
            u[touched[i]] = 0;
        return (int64_t)n_emit;
    }

    /* -- SetU: scatter-add over the three posting tiers --
     * Small DBs skip the touched-list bookkeeping: the U array is
     * cleared during the SetTop scan instead (dense_clear), which
     * matches the reference's plain ++U[Target] inner loop
     * (src/udbusortedsearcher.cpp:396-408).  Large DBs keep the
     * touched list so clearing stays O(candidates). */
    uint32_t *u = s->u;
    int32_t *touched = s->touched;
    uint32_t nt = 0;
    int dense_clear = seq_count <= (1u << 15);
    /* prefetch ahead: the per-word row starts and row heads are random
     * accesses into multi-MB arrays; hide the latency a few words ahead */
    for (uint32_t k = 0; k < nuw; ++k) {
        int64_t w = s->uw[k];
        if (has_csr == 2) {
            /* 16-bit postings (caller guarantees seq_count <= 0xFFFF at
             * flatten time): half the bytes through the DRAM-latency-
             * bound walk */
            const uint16_t *p16 = (const uint16_t *)postings;
            if (k + 4 < nuw) {
                int64_t wn = s->uw[k + 4];
                __builtin_prefetch(&starts[wn], 0, 1);
            }
            if (k + 2 < nuw) {
                int64_t wn = s->uw[k + 2];
                __builtin_prefetch(&p16[starts[wn]], 0, 1);
            }
            int64_t lo = starts[w], hi = starts[w + 1];
            if (dense_clear) {
                for (int64_t p = lo; p < hi; ++p) {
                    uint32_t t = p16[p];
                    if (t < seq_count)
                        ++u[t];
                }
            } else {
                for (int64_t p = lo; p < hi; ++p) {
                    uint32_t t = p16[p];
                    if (t < seq_count) {
                        if (u[t]++ == 0) touched[nt++] = (int32_t)t;
                    }
                }
            }
        } else if (has_csr) {
            if (k + 4 < nuw) {
                int64_t wn = s->uw[k + 4];
                __builtin_prefetch(&starts[wn], 0, 1);
            }
            if (k + 2 < nuw) {
                int64_t wn = s->uw[k + 2];
                __builtin_prefetch(&postings[starts[wn]], 0, 1);
            }
            int64_t lo = starts[w], hi = starts[w + 1];
            if (dense_clear) {
                for (int64_t p = lo; p < hi; ++p) {
                    uint32_t t = (uint32_t)postings[p];
                    if (t < seq_count)
                        ++u[t];
                }
            } else {
                for (int64_t p = lo; p < hi; ++p) {
                    int32_t t = postings[p];
                    if ((uint32_t)t < seq_count) {
                        if (u[t]++ == 0) touched[nt++] = t;
                    }
                }
            }
        }
        if (n_sorted) {
            int64_t lo = lower_bound64(sw, n_sorted, w);
            int64_t hi = lower_bound64(sw, n_sorted, w + 1);
            for (int64_t p = lo; p < hi; ++p) {
                int32_t t = st[p];
                if ((uint32_t)t < seq_count) {
                    if (dense_clear)
                        ++u[t];
                    else if (u[t]++ == 0)
                        touched[nt++] = t;
                }
            }
        }
    }
    /* pending tier is RAW (unsorted, small): one linear pass testing each
     * pair's word against the query-word bitmap */
    for (int64_t p = 0; p < n_pending; ++p) {
        int64_t w = pw[p];
        if (s->seen[w >> 3] & (1u << (w & 7))) {
            int32_t t = pt[p];
            if ((uint32_t)t < seq_count) {
                if (dense_clear)
                    ++u[t];
                else if (u[t]++ == 0)
                    touched[nt++] = t;
            }
        }
    }
    for (uint32_t k = 0; k < nuw; ++k)   /* clear bitmap (touched only) */
        s->seen[s->uw[k] >> 3] = 0;

    /* -- SetTopBump / SetTop: dense index-order scan (fused U clear in
     * dense_clear mode: every slot is read once here anyway).  The scan
     * is blocked: a block whose max can neither emit nor move
     * max_u_seen is skipped after one vectorizable max-reduction, which
     * preserves emission order and the bump schedule exactly.
     * Emissions fill the count-sort histogram and the maxv/nextv
     * running record inline (hist is kept all-zero between calls). */
    uint32_t n_cand = 0;
    uint32_t max_u_seen = 0;
    uint32_t *hist = s->hist;
    uint32_t maxv = 0, nextv = 0;
    enum { RBLK = 64 };
    if (mode == 0 && bump_pct != 0) {
        uint32_t cur_min = 1;
        for (uint32_t t0 = 0; t0 < seq_count; ) {
            uint32_t end = t0 + RBLK <= seq_count ? t0 + RBLK : seq_count;
            uint32_t bm = 0;
            for (uint32_t i = t0; i < end; ++i)
                bm = u[i] > bm ? u[i] : bm;
            if (bm == 0) { t0 = end; continue; }
            if (bm <= max_u_seen && bm < cur_min) {
                if (dense_clear)
                    memset(u + t0, 0, (end - t0) * sizeof(uint32_t));
                t0 = end;
                continue;
            }
            for (uint32_t t = t0; t < end; ++t) {
                uint32_t v = u[t];
                if (dense_clear)
                    u[t] = 0;
                if (v > max_u_seen) {
                    if (v >= cur_min) {
                        out_tix[n_cand] = t;
                        out_counts[n_cand++] = v;
                        ++hist[v];
                        if (v > maxv) { nextv = maxv; maxv = v; }
                        uint32_t nm =
                            (uint32_t)((uint64_t)v * bump_pct / 100);
                        if (cur_min < nm && nm < max_u_seen) cur_min = nm;
                    }
                    max_u_seen = v;
                } else if (v >= cur_min) {
                    out_tix[n_cand] = t;
                    out_counts[n_cand++] = v;
                    ++hist[v];
                    if (v > maxv) { nextv = maxv; maxv = v; }
                }
            }
            t0 = end;
        }
    } else {
        for (uint32_t t0 = 0; t0 < seq_count; ) {
            uint32_t end = t0 + RBLK <= seq_count ? t0 + RBLK : seq_count;
            uint32_t bm = 0;
            for (uint32_t i = t0; i < end; ++i)
                bm = u[i] > bm ? u[i] : bm;
            if (bm == 0) { t0 = end; continue; }
            for (uint32_t t = t0; t < end; ++t) {
                uint32_t v = u[t];
                if (dense_clear)
                    u[t] = 0;
                if (v >= 1) {
                    out_tix[n_cand] = t;
                    out_counts[n_cand++] = v;
                    ++hist[v];
                    if (v > maxv) { nextv = maxv; maxv = v; }
                }
            }
            t0 = end;
        }
    }

    for (uint32_t k = 0; k < nt; ++k)    /* clear u via touched list */
        u[touched[k]] = 0;

    if (n_cand == 0)
        return 0;

    /* -- CountSortOrderDesc: stable desc, cutoff NextValue/2.
     * maxv/nextv and the histogram were filled during the scan (buckets
     * below minv are populated too; the placement loops never read
     * them).  With max_emit > 0 the caller consumes at most that many
     * candidates (the terminator bound), so only buckets down to the
     * one containing the max_emit-th candidate are placed — the exact
     * order prefix, ties included. -- */
    uint32_t minv = nextv / 2;
    uint32_t c_star = minv;
    uint32_t n_emit = 0;
    for (int64_t v = maxv; v >= (int64_t)minv; --v) {
        n_emit += hist[v];
        c_star = (uint32_t)v;
        if (max_emit > 0 && n_emit >= (uint32_t)max_emit)
            break;
    }
    /* descending prefix offsets over the emitted range */
    uint32_t off = 0;
    for (int64_t v = maxv; v >= (int64_t)c_star; --v) {
        uint32_t c = hist[v];
        hist[v] = off;
        off += c;
    }
    /* stable placement into staging, then copy only the emitted
     * prefix back (n_emit is bounded by the terminator, typically a
     * few dozen, vs n_cand in the thousands) */
    uint32_t *stix = s->stage_tix, *scnt = s->stage_cnt;
    for (uint32_t i = 0; i < n_cand; ++i) {
        uint32_t v = out_counts[i];
        if (v < c_star) continue;
        uint32_t pos = hist[v]++;
        stix[pos] = out_tix[i];
        scnt[pos] = v;
    }
    memcpy(out_tix, stix, n_emit * sizeof(uint32_t));
    memcpy(out_counts, scnt, n_emit * sizeof(uint32_t));
    /* restore hist to all-zero for the next call (every filled bucket
     * is <= maxv; [c_star, maxv] hold placement offsets) */
    memset(hist, 0, (maxv + 1) * sizeof(uint32_t));
    return (int64_t)n_emit;
}

/* FastMaskSeq (semantics of usearch12 src/fastmask.cpp FastMaskSeq):
 * homopolymer runs >=5 masked from start+2; tandem 2-mers (both phases)
 * >=5 cols masked (hardmask from start+1, soft from start+2); no
 * end-of-loop flush for the tandem scan.  The reference masks IN PLACE
 * (MaskSeq(Seq,L,Type,Seq), src/seqdb.cpp:446), so with -hardmask the
 * tandem passes read 'N's written by earlier passes — comparisons must
 * read toupper(out[i]) of the evolving buffer, not the original seq. */
#define MASK_UPPER(c) (((c) >= 'a' && (c) <= 'z') ? (uint8_t)((c) - 32) : (c))

void fast_mask_c(const uint8_t *up_unused, uint8_t *out, int64_t L,
                 int hardmask, uint8_t hard_char)
{
    (void)up_unused;
    if (L < 2)
        return;
    const int64_t k1 = 5, j1 = 2, k2 = 5, j2 = 1;

    int lastc = -1;
    int64_t start = -1;
    for (int64_t i = 0; i < L; ++i) {
        int c = MASK_UPPER(out[i]);
        if (c != lastc || i + 1 == L) {
            int64_t n1 = (start >= 0) ? i - start : i + 1;
            if (n1 >= k1 && start >= 0) {
                int64_t lo = start + j1;
                for (int64_t j = lo; j < i; ++j) {
                    if (hardmask)
                        out[j] = hard_char;
                    else if (out[j] >= 'A' && out[j] <= 'Z')
                        out[j] = (uint8_t)(out[j] + 32);
                }
            }
            start = i;
        }
        lastc = c;
    }

    for (int64_t phase = 0; phase <= 1; ++phase) {
        int32_t last_pair = -1;
        start = -((int64_t)1 << 40);
        for (int64_t i = phase; i < L - 1; i += 2) {
            int32_t pair = ((int32_t)MASK_UPPER(out[i]) << 8)
                           + MASK_UPPER(out[i + 1]);
            if (pair != last_pair) {
                int64_t n2 = i - start;
                if (start >= 0 && n2 >= k2) {
                    /* reference quirk: hardmask from start+j2, soft from
                     * start+2*j2 (src/fastmask.cpp:144-151) */
                    int64_t lo = start + (hardmask ? j2 : 2 * j2);
                    for (int64_t j = lo; j < i; ++j) {
                        if (hardmask)
                            out[j] = hard_char;
                        else if (out[j] >= 'A' && out[j] <= 'Z')
                            out[j] = (uint8_t)(out[j] + 32);
                    }
                }
                start = i;
            }
            last_pair = pair;
        }
    }
}

/* DUST low-complexity masking (semantics of usearch12 src/duster.h:31-140,
 * the classic Tatusov/Lipman dust): 64-wide windows stepped by 32; triplet
 * counting over every suffix; score v=10*sum/j; regions with v>level=20
 * masked (soft tolower / hardmask 'N').  Unmasked bytes keep their
 * original case (memcpy, no touppering). */
static int dust_counts[32 * 32 * 32];
static int dust_iis[32 * 32 * 32];
static int dust_mv, dust_iv, dust_jv;

static void dust_wo1(int len, const uint8_t *s, int ivv)
{
    int n1 = 32 * 32 * 32 - 1;
    int nis = 0, i = 0, ii = 0, sum = 0, v = 0;
    for (int j = 0; j < len; ++j, ++s) {
        ii <<= 5;
        uint8_t c = *s;
        if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z')) {
            ii |= (c >= 'a') ? (c - 'a') : (c - 'A');
        } else {
            i = 0;
            continue;
        }
        ii &= n1;
        ++i;
        if (i >= 3) {
            int js;
            for (js = 0; js < nis && dust_iis[js] != ii; ++js)
                ;
            if (js == nis) {
                dust_iis[nis++] = ii;
                dust_counts[ii] = 0;
            }
            int t = dust_counts[ii];
            if (t > 0) {
                sum += t;
                v = 10 * sum / j;
                if (dust_mv < v) {
                    dust_mv = v;
                    dust_iv = ivv;
                    dust_jv = j;
                }
            }
            dust_counts[ii]++;
        }
    }
}

static int dust_wo(int len, const uint8_t *s, int *beg, int *end)
{
    int l1 = len - 3 + 1;
    if (l1 < 0) {
        *beg = 0;
        *end = len - 1;
        return 0;
    }
    dust_mv = 0;
    dust_iv = 0;
    dust_jv = 0;
    for (int i = 0; i < l1; ++i)
        dust_wo1(len - i, s + i, i);
    *beg = dust_iv;
    *end = dust_iv + dust_jv;
    return dust_mv;
}

void dust_mask_c(const uint8_t *s, int64_t ulen, uint8_t *t, int hardmask)
{
    const int window = 64, window2 = 32, level = 20;
    int len = (int)ulen;
    if (t != s)
        memcpy(t, s, (size_t)len);
    int from = 0, to = -1;
    for (int i = 0; i < len; i += window2) {
        from -= window2;
        to -= window2;
        int l = (len > i + window) ? window : len - i;
        int a, b;
        int v = dust_wo(l, s + i, &a, &b);
        int j;
        for (j = from; j <= to; ++j) {
            if (hardmask)
                t[i + j] = 'N';
            else if (t[i + j] >= 'A' && t[i + j] <= 'Z')
                t[i + j] = (uint8_t)(t[i + j] + 32);
        }
        if (v > level) {
            for (j = a; j <= b && j < window2; ++j) {
                if (hardmask)
                    t[i + j] = 'N';
                else if (t[i + j] >= 'A' && t[i + j] <= 'Z')
                    t[i + j] = (uint8_t)(t[i + j] + 32);
            }
            from = j;
            to = b;
        } else {
            from = 0;
            to = -1;
        }
    }
}

/* Alignment path statistics (semantics of align/result.py AlignResult._fill
 * / usearch12 src/arscorer.cpp FillLo:201-296 + gap opens :554-569).
 * out[0..9] = first_m_col, last_m_col, first_m_qpos, first_m_tpos,
 * last_m_qpos, last_m_tpos, id_count, diff_count_a, m_col_count,
 * gap_open_count.  Returns 0, or -1 if the path has no M column. */
int path_stats_c(const uint8_t *path, int64_t col_count,
                 const uint8_t *q, const uint8_t *t,
                 int64_t loi, int64_t loj,
                 const uint8_t *match_mx, const uint8_t *to_upper,
                 int64_t *out)
{
    int64_t qpos = loi, tpos = loj;
    int64_t first_m = -1, last_m = -1;
    int64_t id_count = 0, diff_a = 0, m_cols = 0;
    for (int64_t k = 0; k < col_count; ++k) {
        uint8_t c = path[k];
        if (c == 'M') {
            if (first_m < 0) {
                first_m = k;
                out[2] = qpos;
                out[3] = tpos;
            }
            last_m = k;
            out[4] = qpos;
            out[5] = tpos;
            uint8_t a = q[qpos], b = t[tpos];
            if (match_mx[(size_t)a * 256 + b])
                ++id_count;
            if (to_upper[a] != to_upper[b])
                ++diff_a;
            ++m_cols;
            ++qpos;
            ++tpos;
        } else if (c == 'D') {
            ++qpos;
        } else {
            ++tpos;
        }
    }
    if (first_m < 0)
        return -1;
    int64_t gap_opens = 0;
    uint8_t lastc = 'M';
    for (int64_t k = first_m; k <= last_m; ++k) {
        uint8_t c = path[k];
        if (c != 'M' && lastc == 'M')
            ++gap_opens;
        lastc = c;
    }
    out[0] = first_m;
    out[1] = last_m;
    out[6] = id_count;
    out[7] = diff_a;
    out[8] = m_cols;
    out[9] = gap_opens;
    return 0;
}

/* Fast-path per-strand search loop (semantics of search/driver.py
 * _search_strand + accepter.py -id check + terminator.py counters, i.e.
 * usearch12 Searcher::Align / IsAcceptLo / Terminator::Terminate for the
 * common option set: -id only, no pair-rejection options, no
 * termid/termidd).  Aligns ranked candidates in order, accepting when
 * fract_id >= min_id (and <= max_id when has_max_id), stopping at
 * maxaccepts/maxrejects.  Paths are concatenated into path_buf with
 * acc_off[0..n] offsets.  Returns accepted count, or -1 if path_buf is
 * too small (caller retries with a bigger buffer). */
int64_t search_ranked_c(
    HSPFinderC *hf, AlignScratch *s, const GapParams *gp,
    const uint8_t *match_mx,
    uint32_t band_radius, uint32_t min_hsp_len, float min_hsp_fract,
    float min_hsp_score, float xdrop_g, int full_dp_always,
    int fail_if_no_hsps,
    const uint8_t *tconcat, const int64_t *toffs, const int64_t *tlens,
    const uint32_t *cand, int64_t n_cand,
    const uint8_t *id_mx256,
    float min_id, float max_id, int has_max_id,
    int64_t maxaccepts, int64_t maxrejects,
    uint32_t *acc_tix, int64_t *acc_off, char *path_buf, int64_t path_cap)
{
    int64_t na = 0, nrej = 0, cur = 0;
    acc_off[0] = 0;
    const uint8_t *q = hf->a;
    for (int64_t k = 0; k < n_cand; ++k) {
        uint32_t t = cand[k];
        const uint8_t *tseq = tconcat + toffs[t];
        int64_t tl = tlens[t];
        if (cur + (int64_t)hf->la + tl + 2 > path_cap)
            return -1;
        hsp_set_b(hf, tseq, (uint32_t)tl);
        float fract_unused = 0.0f;
        int n = global_align_c(hf, s, gp, match_mx, band_radius,
                               min_hsp_len, min_hsp_fract, min_hsp_score,
                               xdrop_g, full_dp_always, fail_if_no_hsps,
                               path_buf + cur, &fract_unused);
        int accept = 0;
        if (n > 0) {
            /* GetFractId over the path (arscorer.cpp GetFractId):
             * id M-cols / (last_m - first_m + 1) */
            const char *p = path_buf + cur;
            int64_t qpos = 0, tpos = 0;
            int64_t first_m = -1, last_m = -1, idc = 0;
            for (int64_t c = 0; c < n; ++c) {
                char op = p[c];
                if (op == 'M') {
                    if (first_m < 0)
                        first_m = c;
                    last_m = c;
                    if (id_mx256[(size_t)q[qpos] * 256 + tseq[tpos]])
                        ++idc;
                    ++qpos;
                    ++tpos;
                } else if (op == 'D') {
                    ++qpos;
                } else {
                    ++tpos;
                }
            }
            double fract = 0.0;
            if (first_m >= 0)
                fract = (double)idc / (double)(last_m - first_m + 1);
            accept = !(fract < (double)min_id);
            if (accept && has_max_id && fract > (double)max_id)
                accept = 0;
        }
        if (accept) {
            acc_tix[na] = t;
            cur += n;
            acc_off[++na] = cur;
            if (maxaccepts > 0 && na == maxaccepts)
                break;
        } else {
            ++nrej;
            if (maxrejects > 0 && nrej == maxrejects)
                break;
        }
    }
    return na;
}

/* ScoreLocalPathIgnoreMask (semantics of search/local.py score_local_path /
 * usearch12 src/alnparams.cpp:447-505): M cols score the char-indexed
 * matrix; a gap col scores local_open when the previous col was M, else
 * local_ext.  Accumulates in double, caller casts to f32. */
double score_local_path_c(const uint8_t *q, const uint8_t *t,
                          const char *path, int64_t n,
                          const float *mx,
                          float local_open, float local_ext)
{
    double total = 0.0;
    int64_t qp = 0, tp = 0;
    char last = 'M';
    for (int64_t k = 0; k < n; ++k) {
        char c = path[k];
        if (c == 'M') {
            total += (double)mx[(size_t)q[qp] * 256 + t[tp]];
            ++qp;
            ++tp;
        } else {
            total += (last == 'M') ? (double)local_open
                                   : (double)local_ext;
            if (c == 'D')
                ++qp;
            else
                ++tp;
        }
        last = c;
    }
    return total;
}

/* Unique query/target words in first-occurrence order (semantics of
 * index/udb.py UDBParams.unique_words: rolling word over valid letters,
 * lowercase/invalid letters break the window).  Returns count; out must
 * have capacity L.  Uses the rank scratch's seen bitmap. */
int64_t unique_words_c(RankScratch *s,
                       const uint8_t *seq, int64_t L,
                       const uint8_t *char_to_letter,
                       uint32_t alpha_size, uint32_t wlen,
                       int64_t slot_count, int64_t *out)
{
    if (L < (int64_t)wlen)
        return 0;
    rank_alloc(s, 0, slot_count, 0);
    int64_t pow_w = 1;
    for (uint32_t k = 1; k < wlen; ++k)
        pow_w *= alpha_size;
    int64_t n = 0;
    int64_t word = 0;
    uint32_t run = 0;
    for (int64_t i = 0; i < L; ++i) {
        uint8_t let = char_to_letter[seq[i]];
        if (let == 0xFF) {
            run = 0;
            word = 0;
            continue;
        }
        if (run >= wlen)
            word = (pow_w & (pow_w - 1)) == 0
                ? (word & (pow_w - 1))        /* 4^k alphabet */
                : word - (word / pow_w) * pow_w;
        word = word * alpha_size + let;
        if (++run >= wlen) {
            if (!(s->seen[word >> 3] & (1u << (word & 7)))) {
                s->seen[word >> 3] |= (uint8_t)(1u << (word & 7));
                out[n++] = word;
            }
        }
    }
    for (int64_t k = 0; k < n; ++k)
        s->seen[out[k] >> 3] = 0;
    return n;
}
