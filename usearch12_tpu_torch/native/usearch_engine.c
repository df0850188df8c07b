/* Batch search engine: window-at-a-time native plumbing.
 *
 * The reference engine is a lazy per-query loop (src/search.cpp:51-87,
 * src/udbusortedsearcher.cpp:122-152): rank candidates, align one at a
 * time, stop at maxaccepts/maxrejects.  The TPU-first formulation keeps
 * those exact semantics but restructures the work into window-sized
 * batches so the DP can run on the device in large dispatches:
 *
 *   rank_batch_c   - rank a window of queries (SetTopBump + count-sort
 *                    order per query, capped at maxaccepts+maxrejects)
 *   chain_batch_c  - HSP chain each (query, candidate) pair, align small
 *                    inter-HSP holes inline, and EMIT large holes as a
 *                    packed batch for the device wavefront kernel
 *   finish_replay_c- splice device hole paths into full paths, compute
 *                    alignment stats, and replay the accept/terminate
 *                    loop per query in candidate order (bit-identical
 *                    to the serial loop)
 *   fasta_parse_c  - bulk FASTA parse of a whole buffer
 *
 * All functions are stateless between calls except for the EngineScratch
 * growable buffers.  Python orchestrates windows and the device round
 * trip; see usearch12_tpu/engine/.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include <unistd.h>

typedef uint8_t byte;

typedef struct {
    float open_a, open_b, ext_a, ext_b;
    float l_open_a, l_open_b, r_open_a, r_open_b;
    float l_ext_a, l_ext_b, r_ext_a, r_ext_b;
} GapParams;

/* opaque handles from usearch_native.c */
typedef struct HSPFinderC HSPFinderC;
typedef struct AlignScratch AlignScratch;
typedef struct RankScratch RankScratch;

extern void hsp_set_a(HSPFinderC *hf, const byte *a, uint32_t la);
extern void hsp_set_b(HSPFinderC *hf, const byte *b, uint32_t lb);
extern void hsp_set_b_view(HSPFinderC *hf, const byte *b, uint32_t lb,
                           const uint32_t *words, uint32_t n_words);
extern uint32_t hsp_b_word_count(const HSPFinderC *hf);
extern const uint32_t *hsp_b_words(const HSPFinderC *hf);
extern int global_chain_c(HSPFinderC *hf, AlignScratch *s,
                          const byte *match_mx, uint32_t min_len,
                          float min_fract_id, float min_score, float xdrop_g,
                          int full_dp_always, int fail_if_no_hsps,
                          uint32_t *hsps_out, float *hsp_fract_id);
extern int global_align_c(HSPFinderC *hf, AlignScratch *s,
                          const GapParams *gp, const byte *match_mx,
                          uint32_t band_radius,
                          uint32_t min_global_hsp_length,
                          float min_hsp_fract_id, float min_hsp_score,
                          float xdrop_g, int full_dp_always,
                          int fail_if_no_hsps, char *path_out,
                          float *hsp_fract_id);
extern int nw_band(const byte *a, uint32_t la, const byte *b, uint32_t lb,
                   uint32_t dlo, uint32_t dhi, const GapParams *gp,
                   const float *mx, byte *tb, float *mrow, float *drow,
                   char *path_out, float *score_out);
extern int nw_full(const byte *a, uint32_t la, const byte *b, uint32_t lb,
                   const GapParams *gp, const float *mx, byte *tb,
                   float *mrow, float *drow, char *path_out,
                   float *score_out);
extern int path_stats_c(const uint8_t *path, int64_t col_count,
                        const uint8_t *q, const uint8_t *t, int64_t loi,
                        int64_t loj, const uint8_t *match_mx,
                        const uint8_t *to_upper, int64_t *out);
extern int64_t usort_rank_c(
    RankScratch *s, const uint8_t *seq, uint32_t L,
    const uint8_t *char_to_letter, uint32_t alpha_size, uint32_t wlen,
    int64_t slot_count, const int64_t *starts, const int32_t *postings,
    int has_csr, const int64_t *sw, const int32_t *st, int64_t n_sorted,
    const int64_t *pw, const int32_t *pt, int64_t n_pending,
    uint32_t seq_count, uint32_t bump_pct, int mode, int64_t max_emit,
    uint32_t *out_tix, uint32_t *out_counts);

/* ---------------------------------------------------------------- */
/* growable scratch shared across engine calls                      */

typedef struct EngineScratch {
    byte *tb;           /* DP traceback scratch */
    size_t tb_cap;
    float *mrow, *drow;
    size_t row_cap;
    char *path;         /* per-pair spliced path temp */
    size_t path_cap;
    uint32_t *stage_tix;    /* full-length rank staging */
    uint32_t *stage_cnt;
    size_t stage_cap;
    int32_t *sx_data;       /* sintax per-query compact postings */
    size_t sx_data_cap;
    int64_t *sx_off;
    size_t sx_off_cap;
    uint8_t *sx_seen;       /* sintax window: unique-word bitmap */
    size_t sx_seen_cap;
    int64_t *sx_uw;
    size_t sx_uw_cap;
    uint32_t hsps[512 * 4]; /* per-pair chained HSPs */
    /* target HSP-words cache (chain_batch_c): words for target t live
     * at byte-offset db_off[t]; twc_n[t] = word count + 1 (0 = not
     * cached).  Keyed on the db pointer. */
    const void *twc_db;
    int32_t *twc_n;
    int64_t twc_n_cap;
    uint32_t *twc_words;
    int64_t twc_words_cap;
    /* the scratch whose cache chain_batch_c reads and fills in place of
     * this one's, sized once to the whole db and filled atomically
     * (engine_scratch_share_twc); NULL: this scratch's own */
    struct EngineScratch *twc_src;
} EngineScratch;

EngineScratch *engine_scratch_create(void)
{
    return (EngineScratch *)calloc(1, sizeof(EngineScratch));
}

/* Make es chain with owner's target-words cache (owner may be es).  The
 * owner's cache is sized now to db's n_targets targets and n_letters
 * letters and never moves again; chain_batch_c claims an entry, writes
 * its words and then publishes its count with an atomic store, so
 * scratches chaining on several threads at once share one cache.  The
 * words are a pure function of the target, so the plans stay the same
 * bytes.  Returns 0, or -1 when memory runs out (es keeps its own). */
int engine_scratch_share_twc(EngineScratch *es, EngineScratch *owner,
                             const void *db, int64_t n_targets,
                             int64_t n_letters)
{
    if (owner->twc_src != owner) {
        int32_t *nn = (int32_t *)calloc((size_t)n_targets + 1,
                                        sizeof(int32_t));
        uint32_t *nw = (uint32_t *)malloc(((size_t)n_letters + 1) *
                                          sizeof(uint32_t));
        if (!nn || !nw) {
            free(nn);
            free(nw);
            return -1;
        }
        free(owner->twc_n);
        free(owner->twc_words);
        owner->twc_db = db;
        owner->twc_n = nn;
        owner->twc_n_cap = n_targets;
        owner->twc_words = nw;
        owner->twc_words_cap = n_letters;
        owner->twc_src = owner;
    }
    es->twc_src = owner;
    return 0;
}

void engine_scratch_destroy(EngineScratch *s)
{
    if (!s)
        return;
    free(s->tb);
    free(s->mrow);
    free(s->drow);
    free(s->path);
    free(s->stage_tix);
    free(s->stage_cnt);
    free(s->sx_data);
    free(s->sx_off);
    free(s->sx_seen);
    free(s->sx_uw);
    free(s->twc_n);
    free(s->twc_words);
    free(s);
}

static void eng_alloc_dp(EngineScratch *s, uint32_t la, uint32_t lb)
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

static void eng_alloc_path(EngineScratch *s, size_t need)
{
    if (need > s->path_cap) {
        free(s->path);
        s->path_cap = need + 4096;
        s->path = (char *)malloc(s->path_cap);
    }
}

/* ---------------------------------------------------------------- */
/* bulk FASTA parse
 *
 * Semantics of io/fastx.py read_fasta(stream=True): labels are the bytes
 * after '>' up to (and excluding) the line end; sequence bytes are
 * filtered through keep[256]; empty-sequence records are SKIPPED but
 * recorded (out_empty) so the caller can emit the reference's warning.
 * Returns the record count (skipped empties excluded), or -1 if caps are
 * exceeded (caller grows and retries). */
int64_t fasta_parse_c(const uint8_t *buf, int64_t n, const uint8_t *keep,
                      uint8_t *seq_buf, int64_t seq_cap,
                      int64_t *seq_off,          /* cap: max_rec + 1 */
                      int64_t *lbl_off, int64_t *lbl_end,
                      int64_t max_rec, int64_t *out_empty)
{
    int64_t nrec = 0, spos = 0, nempty = 0;
    int64_t i = 0;
    int64_t cur_lbl_off = -1, cur_lbl_end = -1;
    seq_off[0] = 0;
    while (i < n) {
        /* find end of line (memchr: the byte-at-a-time scan was the
         * whole-load bottleneck at ~100 MB/s; this parses ~1 GB/s) */
        const uint8_t *nl = (const uint8_t *)
            memchr(buf + i, '\n', (size_t)(n - i));
        int64_t eol = nl ? (int64_t)(nl - buf) : n;
        int64_t end = eol;
        if (end > i && buf[end - 1] == '\r')
            --end;
        if (buf[i] == '>') {
            if (cur_lbl_off >= 0) {
                if (spos > seq_off[nrec]) {
                    lbl_off[nrec] = cur_lbl_off;
                    lbl_end[nrec] = cur_lbl_end;
                    ++nrec;
                    if (nrec >= max_rec)
                        return -1;
                    seq_off[nrec] = spos;
                } else {
                    ++nempty;
                }
            }
            cur_lbl_off = i + 1;
            cur_lbl_end = end;
        } else if (cur_lbl_off >= 0) {
            /* copy the whole line, then verify every byte is kept —
             * true for any real sequence line; compact only on the
             * rare line with embedded deletable bytes */
            int64_t len = end - i;
            if (spos + len > seq_cap)
                return -1;
            memcpy(seq_buf + spos, buf + i, (size_t)len);
            int64_t k = i;
            /* branchless 8-wide keep check: one branch per 8 bytes */
            while (k + 8 <= end) {
                unsigned m = keep[buf[k]] & keep[buf[k + 1]]
                           & keep[buf[k + 2]] & keep[buf[k + 3]]
                           & keep[buf[k + 4]] & keep[buf[k + 5]]
                           & keep[buf[k + 6]] & keep[buf[k + 7]];
                if (!m)
                    break;
                k += 8;
            }
            while (k < end && keep[buf[k]])
                ++k;
            if (k == end) {
                spos += len;
            } else {
                int64_t w = spos + (k - i);
                for (; k < end; ++k) {
                    uint8_t c = buf[k];
                    if (keep[c])
                        seq_buf[w++] = c;
                }
                spos = w;
            }
        }
        i = eol + 1;
    }
    if (cur_lbl_off >= 0) {
        if (spos > seq_off[nrec]) {
            lbl_off[nrec] = cur_lbl_off;
            lbl_end[nrec] = cur_lbl_end;
            ++nrec;
            seq_off[nrec] = spos;
        } else {
            ++nempty;
        }
    }
    *out_empty = nempty;
    return nrec;
}

/* ---------------------------------------------------------------- */
/* FastMask a concatenated DB in place (out must be pre-uppercased) */
extern void fast_mask_c(const uint8_t *up_unused, uint8_t *out, int64_t L,
                        int hardmask, uint8_t hard_char);

void fast_mask_batch_c(uint8_t *out, const int64_t *offs, int64_t n,
                       int hardmask, uint8_t hard_char)
{
    for (int64_t i = 0; i < n; ++i)
        fast_mask_c(out + offs[i], out + offs[i],
                    offs[i + 1] - offs[i], hardmask, hard_char);
}

/* ---------------------------------------------------------------- */
/* batched ranking: usort_rank_c per job seq, top-K kept.
 * out_tix/out_counts are (n_jobs, K); out_n[j] = kept count (<=K);
 * out_more[j] = 1 if the full candidate list was longer than K (the
 * caller must fall back to an uncapped rank for that job). */
int64_t rank_batch_c(
    RankScratch *rs, EngineScratch *es,
    const uint8_t *jbuf, const int64_t *j_off, int64_t n_jobs,
    const uint8_t *char_to_letter, uint32_t alpha_size, uint32_t wlen,
    int64_t slot_count,
    const int64_t *starts, const int32_t *postings, int has_csr,
    const int64_t *sw, const int32_t *st, int64_t n_sorted,
    const int64_t *pw, const int32_t *pt, int64_t n_pending,
    uint32_t seq_count, uint32_t bump_pct, int mode, int64_t K,
    uint32_t *out_tix, uint32_t *out_counts, int32_t *out_n,
    uint8_t *out_more)
{
    if ((size_t)seq_count + 64 > es->stage_cap) {
        free(es->stage_tix);
        free(es->stage_cnt);
        es->stage_cap = (size_t)seq_count * 2 + 1024;
        es->stage_tix = (uint32_t *)malloc(es->stage_cap * sizeof(uint32_t));
        es->stage_cnt = (uint32_t *)malloc(es->stage_cap * sizeof(uint32_t));
    }
    for (int64_t j = 0; j < n_jobs; ++j) {
        const uint8_t *seq = jbuf + j_off[j];
        int64_t L = j_off[j + 1] - j_off[j];
        int64_t nc = usort_rank_c(rs, seq, (uint32_t)L, char_to_letter,
                                  alpha_size, wlen, slot_count, starts,
                                  postings, has_csr, sw, st, n_sorted, pw,
                                  pt, n_pending, seq_count, bump_pct, mode,
                                  K, es->stage_tix, es->stage_cnt);
        int64_t keep = nc < K ? nc : K;
        memcpy(out_tix + j * K, es->stage_tix, keep * sizeof(uint32_t));
        memcpy(out_counts + j * K, es->stage_cnt, keep * sizeof(uint32_t));
        out_n[j] = (int32_t)keep;
        out_more[j] = nc > K;
    }
    return n_jobs;
}

/* ---------------------------------------------------------------- */
/* hole gap-parameter class (AlnParams::Init terminal adjustment,
 * mirrored from align_hole in usearch_native.c / ops/batch_align.py) */
static void hole_params(const GapParams *gp, int left_a, int left_b,
                        int right_a, int right_b, GapParams *lp)
{
    lp->open_a = gp->open_a;
    lp->open_b = gp->open_b;
    lp->ext_a = gp->ext_a;
    lp->ext_b = gp->ext_b;
    lp->l_open_a = left_a ? gp->l_open_a : gp->open_a;
    lp->l_ext_a = left_a ? gp->l_ext_a : gp->ext_a;
    lp->l_open_b = left_b ? gp->l_open_b : gp->open_b;
    lp->l_ext_b = left_b ? gp->l_ext_b : gp->ext_b;
    lp->r_open_a = right_a ? gp->r_open_a : gp->open_a;
    lp->r_ext_a = right_a ? gp->r_ext_a : gp->ext_a;
    lp->r_open_b = right_b ? gp->r_open_b : gp->open_b;
    lp->r_ext_b = right_b ? gp->r_ext_b : gp->ext_b;
}

static void eng_band_range(uint32_t la, uint32_t lb, uint32_t band_radius,
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

/* segment kinds in the per-pair splice plan */
#define SEG_M 0
#define SEG_I 1
#define SEG_D 2
#define SEG_HOLE 3     /* seg_val = hole index (device-aligned) */
#define SEG_LIT 4      /* seg_val = offset into lit_buf, seg_val2 = len */

/* pair statuses */
#define PAIR_FAIL 0    /* not aligned (gates) */
#define PAIR_PLAN 1    /* plan emitted */

/* Point hf's target at db's target t, its HSP words from the target-words
 * cache: es's own (grown as targets come), or the shared one that
 * engine_scratch_share_twc gave es, whose slot is 0 (free), -1 (being
 * written by another thread) or the word count + 1. */
static void chain_set_b(EngineScratch *es, HSPFinderC *hf,
                        const uint8_t *db, const int64_t *db_off,
                        const int64_t *db_len, uint32_t t)
{
    const uint8_t *b = db + db_off[t];
    uint32_t lb = (uint32_t)db_len[t];
    int64_t wend = db_off[t] + db_len[t];
    const EngineScratch *tw = es->twc_src;
    if (tw && tw->twc_db == (const void *)db && (int64_t)t < tw->twc_n_cap
        && wend <= tw->twc_words_cap) {
        int32_t *slot = &tw->twc_n[t];
        int32_t n = __atomic_load_n(slot, __ATOMIC_ACQUIRE);
        int32_t empty = 0;
        if (n > 0) {
            hsp_set_b_view(hf, b, lb, tw->twc_words + db_off[t],
                           (uint32_t)(n - 1));
            return;
        }
        hsp_set_b(hf, b, lb);
        if (n == 0 && __atomic_compare_exchange_n(slot, &empty, -1, 0,
                                                  __ATOMIC_ACQUIRE,
                                                  __ATOMIC_RELAXED)) {
            uint32_t nwb = hsp_b_word_count(hf);
            memcpy(tw->twc_words + db_off[t], hsp_b_words(hf),
                   (size_t)nwb * sizeof(uint32_t));
            __atomic_store_n(slot, (int32_t)nwb + 1, __ATOMIC_RELEASE);
        }
        return;
    }
    if (es->twc_db != (const void *)db) {
        es->twc_db = (const void *)db;
        if (es->twc_n)
            memset(es->twc_n, 0, (size_t)es->twc_n_cap * sizeof(int32_t));
    }
    if ((int64_t)t >= es->twc_n_cap) {
        int64_t nc = (int64_t)t * 2 + 1024;
        int32_t *nn = (int32_t *)calloc((size_t)nc, sizeof(int32_t));
        if (es->twc_n) {
            memcpy(nn, es->twc_n, (size_t)es->twc_n_cap * sizeof(int32_t));
            free(es->twc_n);
        }
        es->twc_n = nn;
        es->twc_n_cap = nc;
    }
    if (wend > es->twc_words_cap) {
        int64_t nc = wend * 2 + 4096;
        uint32_t *nw = (uint32_t *)realloc(
            es->twc_words, (size_t)nc * sizeof(uint32_t));
        es->twc_words = nw;
        es->twc_words_cap = nc;
    }
    if (es->twc_n[t] == 0) {
        hsp_set_b(hf, b, lb);
        uint32_t nwb = hsp_b_word_count(hf);
        memcpy(es->twc_words + db_off[t], hsp_b_words(hf),
               (size_t)nwb * sizeof(uint32_t));
        es->twc_n[t] = (int32_t)nwb + 1;
    } else {
        hsp_set_b_view(hf, b, lb, es->twc_words + db_off[t],
                       (uint32_t)(es->twc_n[t] - 1));
    }
}

/* Chain a batch of pairs.  Pairs must be grouped by job (pair_j) so the
 * query word dictionary is built once per job.  Holes with
 * leni*lenj >= dev_min_cells are emitted to the hole arrays (device);
 * smaller holes (and everything when dev_min_cells < 0 is given as a
 * huge number) are banded-NW'd inline into lit_buf.  seg_val2 is a
 * SEG_LIT's length and 0 for every other kind, so the plan's bytes are
 * defined wherever it is used.
 * Returns the hole count, or -(1+needed_kind) on capacity overflow:
 *   -1 seg cap, -2 hole cap, -3 lit cap.  Caller grows and retries. */
int64_t chain_batch_c(
    HSPFinderC *hf, AlignScratch *as, EngineScratch *es,
    const GapParams *gp, const float *sub_mx, const byte *match_mx,
    uint32_t band_radius, uint32_t min_hsp_len, float min_hsp_fract,
    float min_hsp_score, float xdrop_g, int full_dp_always,
    int fail_if_no_hsps,
    const uint8_t *jbuf, const int64_t *j_off,
    const uint8_t *db, const int64_t *db_off, const int64_t *db_len,
    const int32_t *pair_j, const uint32_t *pair_t, int64_t n_pairs,
    int64_t dev_min_cells,
    uint8_t *status,
    uint8_t *seg_kind, int64_t *seg_val, int64_t *seg_val2,
    int64_t *pair_seg_off, int64_t seg_cap,
    int32_t *hole_pair, int64_t *hole_aoff, int64_t *hole_boff,
    int32_t *hole_alen, int32_t *hole_blen, uint8_t *hole_cls,
    int64_t hole_cap,
    char *lit_buf, int64_t lit_cap)
{
    int64_t n_seg = 0, n_hole = 0, lit_pos = 0;
    int32_t last_j = -1;
    pair_seg_off[0] = 0;
    for (int64_t p = 0; p < n_pairs; ++p) {
        int32_t j = pair_j[p];
        const uint8_t *a = jbuf + j_off[j];
        uint32_t la = (uint32_t)(j_off[j + 1] - j_off[j]);
        if (j != last_j) {
            hsp_set_a(hf, a, la);
            last_j = j;
        }
        uint32_t t = pair_t[p];
        const uint8_t *b = db + db_off[t];
        uint32_t lb = (uint32_t)db_len[t];
        /* target-words cache: with maxaccepts+maxrejects candidates
         * per query, every target's words are re-extracted many times
         * per window without it */
        chain_set_b(es, hf, db, db_off, db_len, t);
        float fract = 0.0f;
        int nch = global_chain_c(hf, as, match_mx, min_hsp_len,
                                 min_hsp_fract, min_hsp_score, xdrop_g,
                                 full_dp_always, fail_if_no_hsps, es->hsps,
                                 &fract);
        if (nch == -1) {
            status[p] = PAIR_FAIL;
            pair_seg_off[p + 1] = n_seg;
            continue;
        }
        status[p] = PAIR_PLAN;
        /* hole list for this pair: chained HSPs with gaps between them,
         * or the whole pair as one terminal hole (fallback / fulldp) */
        int64_t n_items;
        /* item: hloi, hloj, hleni, hlenj, then optional M run */
        if (nch == -2 || nch == -3) {
            /* -2: no chain -> whole-pair banded NW fallback
             * -3: full_dp_always -> whole-pair FULL NW (band 0) */
            if (n_seg + 1 > seg_cap)
                return -1;
            uint64_t cells = (uint64_t)la * lb;
            int force_host = (nch == -3);
            if (!force_host && (int64_t)cells >= dev_min_cells) {
                if (n_hole + 1 > hole_cap)
                    return -2;
                hole_pair[n_hole] = (int32_t)p;
                hole_aoff[n_hole] = j_off[j];
                hole_boff[n_hole] = db_off[t];
                hole_alen[n_hole] = (int32_t)la;
                hole_blen[n_hole] = (int32_t)lb;
                hole_cls[n_hole] = 0xF;   /* all four edges terminal */
                seg_kind[n_seg] = SEG_HOLE;
                seg_val[n_seg] = n_hole;
                seg_val2[n_seg] = 0;
                ++n_hole;
                ++n_seg;
            } else {
                if (lit_pos + la + lb + 2 > lit_cap)
                    return -3;
                eng_alloc_dp(es, la, lb);
                float score;
                int n;
                if (nch == -3 || band_radius == 0) {
                    n = nw_full(a, la, b, lb, gp, sub_mx, es->tb, es->mrow,
                                es->drow, lit_buf + lit_pos, &score);
                } else {
                    uint32_t dlo, dhi;
                    eng_band_range(la, lb, band_radius, &dlo, &dhi);
                    n = nw_band(a, la, b, lb, dlo, dhi, gp, sub_mx, es->tb,
                                es->mrow, es->drow, lit_buf + lit_pos,
                                &score);
                }
                if (n < 0)
                    return -4;
                seg_kind[n_seg] = SEG_LIT;
                seg_val[n_seg] = lit_pos;
                seg_val2[n_seg] = n;
                lit_pos += n;
                ++n_seg;
            }
            pair_seg_off[p + 1] = n_seg;
            continue;
        }
        /* chained HSPs: holes between them (GlobalAlign_AllOpts walk) */
        uint32_t prev_hii = 0, prev_hij = 0;
        int have_prev = 0;
        n_items = nch + 1;
        for (int64_t i = 0; i < n_items; ++i) {
            uint32_t hloi, hloj, hleni, hlenj;
            if (i < nch) {
                const uint32_t *h = &es->hsps[4 * i];
                if (!have_prev) {
                    hloi = 0;
                    hloj = 0;
                    hleni = h[0];
                    hlenj = h[1];
                } else {
                    hloi = prev_hii + 1;
                    hloj = prev_hij + 1;
                    hleni = h[0] - prev_hii - 1;
                    hlenj = h[1] - prev_hij - 1;
                }
            } else {
                hloi = prev_hii + 1;
                hloj = prev_hij + 1;
                hleni = la - hloi;
                hlenj = lb - hloj;
            }
            /* emit the hole */
            if (hleni == 0 && hlenj > 0) {
                if (n_seg + 1 > seg_cap)
                    return -1;
                seg_kind[n_seg] = SEG_I;
                seg_val[n_seg] = hlenj;
                seg_val2[n_seg] = 0;
                ++n_seg;
            } else if (hlenj == 0 && hleni > 0) {
                if (n_seg + 1 > seg_cap)
                    return -1;
                seg_kind[n_seg] = SEG_D;
                seg_val[n_seg] = hleni;
                seg_val2[n_seg] = 0;
                ++n_seg;
            } else if (hleni > 0 && hlenj > 0) {
                if (n_seg + 1 > seg_cap)
                    return -1;
                uint64_t cells = (uint64_t)hleni * hlenj;
                int left_a = hloi == 0, left_b = hloj == 0;
                int right_a = hloi + hleni == la;
                int right_b = hloj + hlenj == lb;
                if ((int64_t)cells >= dev_min_cells) {
                    if (n_hole + 1 > hole_cap)
                        return -2;
                    hole_pair[n_hole] = (int32_t)p;
                    hole_aoff[n_hole] = j_off[j] + hloi;
                    hole_boff[n_hole] = db_off[t] + hloj;
                    hole_alen[n_hole] = (int32_t)hleni;
                    hole_blen[n_hole] = (int32_t)hlenj;
                    hole_cls[n_hole] = (uint8_t)(left_a | (left_b << 1) |
                                                 (right_a << 2) |
                                                 (right_b << 3));
                    seg_kind[n_seg] = SEG_HOLE;
                    seg_val[n_seg] = n_hole;
                    seg_val2[n_seg] = 0;
                    ++n_hole;
                    ++n_seg;
                } else {
                    if (lit_pos + hleni + hlenj + 2 > lit_cap)
                        return -3;
                    GapParams lp;
                    hole_params(gp, left_a, left_b, right_a, right_b, &lp);
                    eng_alloc_dp(es, hleni, hlenj);
                    float score;
                    int n;
                    if (band_radius == 0) {
                        n = nw_full(a + hloi, hleni, b + hloj, hlenj, &lp,
                                    sub_mx, es->tb, es->mrow, es->drow,
                                    lit_buf + lit_pos, &score);
                    } else {
                        uint32_t dlo, dhi;
                        eng_band_range(hleni, hlenj, band_radius, &dlo,
                                       &dhi);
                        n = nw_band(a + hloi, hleni, b + hloj, hlenj, dlo,
                                    dhi, &lp, sub_mx, es->tb, es->mrow,
                                    es->drow, lit_buf + lit_pos, &score);
                    }
                    if (n < 0)
                        return -4;
                    seg_kind[n_seg] = SEG_LIT;
                    seg_val[n_seg] = lit_pos;
                    seg_val2[n_seg] = n;
                    lit_pos += n;
                    ++n_seg;
                }
            }
            if (i < nch) {
                const uint32_t *h = &es->hsps[4 * i];
                if (n_seg + 1 > seg_cap)
                    return -1;
                seg_kind[n_seg] = SEG_M;
                seg_val[n_seg] = h[2];
                seg_val2[n_seg] = 0;
                ++n_seg;
                prev_hii = h[0] + h[2] - 1;
                prev_hij = h[1] + h[3] - 1;
                have_prev = 1;
            }
        }
        pair_seg_off[p + 1] = n_seg;
    }
    return n_hole;
}

/* ---------------------------------------------------------------- */
/* A split chain round (engine/batch.py: BatchEngine._chain_split).
 *
 * A round's pairs, cut at job boundaries into n slices (cuts[0] = 0 ..
 * cuts[n] = n_pairs), are chained at once, each on a scratch of its own
 * (a row of tab), by the caller and the threads of a ChainPool, each
 * taking the next slice left, so that no round waits for a thread still
 * asleep: where every thread sleeps, the caller chains every slice.  The
 * threads are the pool's own, made once with it, and never enter the
 * interpreter.  chain_plans_merge_c then appends the slices' plans in
 * order into the window's arrays, the bytes one chain_batch_c call over
 * the whole round writes.
 *
 * A round is posted in one atomic word, post = round << 32 | n << 16 |
 * next slice, and a slice is taken by a compare-and-swap of that word,
 * so a thread takes a slice only of the round the word holds, and sees
 * that round's arguments; the caller posts the next round only once every
 * slice taken is done. */

#include <pthread.h>
#include <time.h>

/* a slice scratch's row of tab: hf, as, es, seg_kind, seg_val,
 * seg_val2, seg_cap, hole_pair, hole_aoff, hole_boff, hole_alen,
 * hole_blen, hole_cls, hole_cap, lit_buf, lit_cap */
#define CP_ROW 16
/* a thread that found no slice left looks for the next round this long
 * before it sleeps: a round's replay and the next round's set-up take
 * less */
#define CP_SPIN_NS 1000000L
#define CP_MAX_SLICES 0xFFFF
#if defined(__x86_64__) || defined(__i386__)
#define CP_RELAX() __builtin_ia32_pause()
#elif defined(__aarch64__)
#define CP_RELAX() __asm__ __volatile__("yield")
#else
#define CP_RELAX() do {} while (0)
#endif

typedef struct {
    const GapParams *gp;
    const float *sub_mx;
    const byte *match_mx;
    uint32_t band_radius, min_hsp_len;
    float min_hsp_fract, min_hsp_score, xdrop_g;
    int full_dp_always, fail_if_no_hsps;
    const uint8_t *jbuf;
    const int64_t *j_off;
    const uint8_t *db;
    const int64_t *db_off, *db_len;
    const int32_t *pair_j;
    const uint32_t *pair_t;
    int64_t dev_min_cells;
    uint8_t *status;
    int64_t *pso;          /* slice k's pair_seg_off at cuts[k] + k */
    const int64_t *todo, *cuts, *tab;
    int64_t *res;          /* a slice: chain_batch_c's return, its
                            * segments, its literal bytes */
} ChainRound;

typedef struct {
    pthread_mutex_t mu;
    pthread_cond_t go;
    uint64_t post;         /* round << 32 | n << 16 | next slice */
    int64_t done;          /* the round's slices chained */
    int sleepers;
    int stop;
    int n_threads;
    pthread_t *threads;
    ChainRound r;
} ChainPool;

static int64_t cp_ns_since(const struct timespec *t0)
{
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (int64_t)(t.tv_sec - t0->tv_sec) * 1000000000L
           + (t.tv_nsec - t0->tv_nsec);
}

/* the literal bytes of a plan of n_seg segments */
int64_t chain_plan_lit_bytes(const uint8_t *kind, const int64_t *val,
                             const int64_t *val2, int64_t n_seg)
{
    for (int64_t s = n_seg - 1; s >= 0; --s)
        if (kind[s] == SEG_LIT)
            return val[s] + val2[s];
    return 0;
}

/* Take the next slice of round `round` (the word's top 32 bits): its
 * index into todo, or -1 where that round has none left or is over. */
static int64_t cp_take(ChainPool *p, uint32_t round)
{
    uint64_t w = __atomic_load_n(&p->post, __ATOMIC_ACQUIRE);
    for (;;) {
        if ((uint32_t)(w >> 32) != round
            || (w & CP_MAX_SLICES) >= ((w >> 16) & CP_MAX_SLICES))
            return -1;
        if (__atomic_compare_exchange_n(&p->post, &w, w + 1, 0,
                                        __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE))
            return (int64_t)(w & CP_MAX_SLICES);
    }
}

static void cp_chain(const ChainRound *r, int64_t i)
{
    int64_t k = r->todo[i];
    const int64_t *row = r->tab + k * CP_ROW;
    int64_t lo = r->cuts[k], n_pairs = r->cuts[k + 1] - lo;
    int64_t *pso = r->pso + lo + k;
    int64_t *res = r->res + 3 * k;
    res[0] = chain_batch_c(
        (HSPFinderC *)row[0], (AlignScratch *)row[1],
        (EngineScratch *)row[2], r->gp, r->sub_mx, r->match_mx,
        r->band_radius, r->min_hsp_len, r->min_hsp_fract,
        r->min_hsp_score, r->xdrop_g, r->full_dp_always,
        r->fail_if_no_hsps, r->jbuf, r->j_off, r->db, r->db_off,
        r->db_len, r->pair_j + lo, r->pair_t + lo, n_pairs,
        r->dev_min_cells, r->status + lo,
        (uint8_t *)row[3], (int64_t *)row[4], (int64_t *)row[5], pso,
        row[6], (int32_t *)row[7], (int64_t *)row[8], (int64_t *)row[9],
        (int32_t *)row[10], (int32_t *)row[11], (uint8_t *)row[12],
        row[13], (char *)row[14], row[15]);
    if (res[0] >= 0) {
        res[1] = pso[n_pairs];
        res[2] = chain_plan_lit_bytes((const uint8_t *)row[3],
                                      (const int64_t *)row[4],
                                      (const int64_t *)row[5], res[1]);
    }
}

/* Take and chain the slices of `round` until none is left. */
static void cp_work(ChainPool *p, uint32_t round)
{
    int64_t i;
    while ((i = cp_take(p, round)) >= 0) {
        cp_chain(&p->r, i);
        __atomic_add_fetch(&p->done, 1, __ATOMIC_RELEASE);
    }
}

/* A thread's life: help with each round posted after `seen`, spinning
 * CP_SPIN_NS for the next one before it sleeps, until the pool stops. */
static void *cp_serve(void *arg)
{
    ChainPool *p = (ChainPool *)arg;
    uint32_t seen = (uint32_t)(__atomic_load_n(&p->post, __ATOMIC_ACQUIRE)
                               >> 32);
    for (;;) {
        struct timespec t0;
        clock_gettime(CLOCK_MONOTONIC, &t0);
        uint32_t round;
        for (unsigned i = 1;; ++i) {
            round = (uint32_t)(__atomic_load_n(&p->post, __ATOMIC_ACQUIRE)
                               >> 32);
            if (round != seen || __atomic_load_n(&p->stop, __ATOMIC_ACQUIRE))
                break;
            if ((i & 1023) == 0 && cp_ns_since(&t0) > CP_SPIN_NS) {
                pthread_mutex_lock(&p->mu);
                ++p->sleepers;
                while ((uint32_t)(__atomic_load_n(&p->post, __ATOMIC_ACQUIRE)
                                  >> 32) == seen && !p->stop)
                    pthread_cond_wait(&p->go, &p->mu);
                --p->sleepers;
                pthread_mutex_unlock(&p->mu);
            }
            CP_RELAX();
        }
        if (__atomic_load_n(&p->stop, __ATOMIC_ACQUIRE))
            return NULL;
        seen = round;
        cp_work(p, round);
    }
}

/* A pool of n_threads threads (fewer where the system gives fewer; NULL
 * where it gives no memory).  One caller of chain_split_c at a time. */
ChainPool *chain_pool_create(int n_threads)
{
    ChainPool *p = (ChainPool *)calloc(1, sizeof(ChainPool));
    if (!p)
        return NULL;
    p->threads = (pthread_t *)calloc((size_t)(n_threads > 0 ? n_threads
                                              : 1), sizeof(pthread_t));
    if (!p->threads) {
        free(p);
        return NULL;
    }
    pthread_mutex_init(&p->mu, NULL);
    pthread_cond_init(&p->go, NULL);
    for (int t = 0; t < n_threads; ++t) {
        if (pthread_create(&p->threads[t], NULL, cp_serve, p) != 0)
            break;
        ++p->n_threads;
    }
    return p;
}

/* Stop the pool's threads, wait for them and free it. */
void chain_pool_destroy(ChainPool *p)
{
    if (!p)
        return;
    pthread_mutex_lock(&p->mu);
    __atomic_store_n(&p->stop, 1, __ATOMIC_RELEASE);
    pthread_cond_broadcast(&p->go);
    pthread_mutex_unlock(&p->mu);
    for (int t = 0; t < p->n_threads; ++t)
        pthread_join(p->threads[t], NULL);
    pthread_mutex_destroy(&p->mu);
    pthread_cond_destroy(&p->go);
    free(p->threads);
    free(p);
}

/* Chain the slices todo[0 .. n_todo) of a round at once (n_todo at most
 * CP_MAX_SLICES).  Each slice k's row of res is chain_batch_c's return
 * (negative: the caller grows that slice's scratch and chains it again),
 * its segments and its literal bytes; its status goes to status[cuts[k]
 * ..], its pair_seg_off to pso[cuts[k] + k ..]. */
void chain_split_c(
    ChainPool *p, int64_t n_todo, const int64_t *todo, const int64_t *cuts,
    const int64_t *tab, int64_t *res, uint8_t *status, int64_t *pso,
    const GapParams *gp, const float *sub_mx, const byte *match_mx,
    uint32_t band_radius, uint32_t min_hsp_len, float min_hsp_fract,
    float min_hsp_score, float xdrop_g, int full_dp_always,
    int fail_if_no_hsps,
    const uint8_t *jbuf, const int64_t *j_off,
    const uint8_t *db, const int64_t *db_off, const int64_t *db_len,
    const int32_t *pair_j, const uint32_t *pair_t, int64_t dev_min_cells)
{
    ChainRound *r = &p->r;
    r->gp = gp;
    r->sub_mx = sub_mx;
    r->match_mx = match_mx;
    r->band_radius = band_radius;
    r->min_hsp_len = min_hsp_len;
    r->min_hsp_fract = min_hsp_fract;
    r->min_hsp_score = min_hsp_score;
    r->xdrop_g = xdrop_g;
    r->full_dp_always = full_dp_always;
    r->fail_if_no_hsps = fail_if_no_hsps;
    r->jbuf = jbuf;
    r->j_off = j_off;
    r->db = db;
    r->db_off = db_off;
    r->db_len = db_len;
    r->pair_j = pair_j;
    r->pair_t = pair_t;
    r->dev_min_cells = dev_min_cells;
    r->status = status;
    r->pso = pso;
    r->todo = todo;
    r->cuts = cuts;
    r->tab = tab;
    r->res = res;
    __atomic_store_n(&p->done, 0, __ATOMIC_RELAXED);
    uint32_t round = (uint32_t)(__atomic_load_n(&p->post, __ATOMIC_RELAXED)
                                >> 32) + 1;
    __atomic_store_n(&p->post, (uint64_t)round << 32
                     | (uint64_t)n_todo << 16, __ATOMIC_RELEASE);
    pthread_mutex_lock(&p->mu);
    if (p->sleepers)
        pthread_cond_broadcast(&p->go);
    pthread_mutex_unlock(&p->mu);
    cp_work(p, round);
    /* the slices left are on threads that are chaining them */
    while (__atomic_load_n(&p->done, __ATOMIC_ACQUIRE) < n_todo)
        CP_RELAX();
}

/* Append the n slices' plans in order into the window's arrays (d_*):
 * slice k's segment offsets at cuts[k] (each + the segments before it),
 * its segments (a SEG_HOLE's index + the holes before it, a SEG_LIT's
 * offset + the literal bytes before it), its holes (each pair +
 * cuts[k]) and its literal bytes: the arrays one chain_batch_c call over
 * the round writes.  res and pso as chain_split_c left them; returns the
 * round's holes. */
int64_t chain_plans_merge_c(
    int64_t n, const int64_t *cuts, const int64_t *tab, const int64_t *res,
    const int64_t *pso, int64_t *d_pso,
    uint8_t *d_seg_kind, int64_t *d_seg_val, int64_t *d_seg_val2,
    int32_t *d_hole_pair, int64_t *d_hole_aoff, int64_t *d_hole_boff,
    int32_t *d_hole_alen, int32_t *d_hole_blen, uint8_t *d_hole_cls,
    char *d_lit_buf)
{
    int64_t seg0 = 0, hole0 = 0, lit0 = 0;
    d_pso[0] = 0;
    for (int64_t k = 0; k < n; ++k) {
        const int64_t *row = tab + k * CP_ROW;
        const uint8_t *kind = (const uint8_t *)row[3];
        const int64_t *val = (const int64_t *)row[4];
        int64_t lo = cuts[k], n_pairs = cuts[k + 1] - lo;
        int64_t n_hole = res[3 * k], n_seg = res[3 * k + 1];
        int64_t n_lit = res[3 * k + 2];
        for (int64_t q = 1; q <= n_pairs; ++q)
            d_pso[lo + q] = pso[lo + k + q] + seg0;
        memcpy(d_seg_kind + seg0, kind, (size_t)n_seg);
        memcpy(d_seg_val2 + seg0, (const int64_t *)row[5],
               (size_t)n_seg * sizeof(int64_t));
        for (int64_t s = 0; s < n_seg; ++s)
            d_seg_val[seg0 + s] = val[s] + (kind[s] == SEG_HOLE ? hole0
                                            : kind[s] == SEG_LIT ? lit0
                                            : 0);
        const int32_t *hp = (const int32_t *)row[7];
        for (int64_t h = 0; h < n_hole; ++h)
            d_hole_pair[hole0 + h] = hp[h] + (int32_t)lo;
        memcpy(d_hole_aoff + hole0, (const int64_t *)row[8],
               (size_t)n_hole * sizeof(int64_t));
        memcpy(d_hole_boff + hole0, (const int64_t *)row[9],
               (size_t)n_hole * sizeof(int64_t));
        memcpy(d_hole_alen + hole0, (const int32_t *)row[10],
               (size_t)n_hole * sizeof(int32_t));
        memcpy(d_hole_blen + hole0, (const int32_t *)row[11],
               (size_t)n_hole * sizeof(int32_t));
        memcpy(d_hole_cls + hole0, (const uint8_t *)row[12], (size_t)n_hole);
        memcpy(d_lit_buf + lit0, (const char *)row[14], (size_t)n_lit);
        seg0 += n_seg;
        hole0 += n_hole;
        lit0 += n_lit;
    }
    return hole0;
}

/* ---------------------------------------------------------------- */
/* Greedy clustering window driver.
 *
 * The UCLUST greedy loop (src/clusterfast.cpp:119-129 +
 * src/clustersink.cpp:306-360) is strictly sequential: query i's
 * candidate set includes centroids admitted by queries < i.  This
 * driver runs the EXACT serial semantics for a window of queries in one
 * native call: per query it ranks against the frozen posting tiers plus
 * a C-managed "delta" tier of centroids admitted inside the window,
 * aligns candidates lazily (maxaccepts/maxrejects), and either joins
 * the top hit's cluster or admits the query as a new centroid.  The
 * window ends when the delta tier fills (the caller folds admissions
 * into its index and re-freezes) or an output buffer nears capacity.
 *
 * Rank semantics are identical to usort_rank_c: the delta tier adds
 * into the same U array before the SetTopBump index-order scan, so
 * candidate order matches the serial path bit-for-bit. */

/* raw tier flushes to the mid CSR at this many pending postings; the
 * mid CSR folds into the base CSR once it outgrows base/4 */
#define CC_RAW_LIMIT 8192

typedef struct {
    /* C-owned growing posting index (word -> centroid), 3 tiers:
     *   base CSR  (large, folded rarely)
     *   mid  CSR  (merged from raw flushes)
     *   raw  (word, tix) append tail, scanned via the query-word bitmap
     * Per-word posting order is admission order across tiers (base
     * oldest), which rank never depends on — U is a pure count. */
    int64_t v;             /* slot count; 0 = not initialized */
    int64_t *base_starts;  /* v+1 */
    int32_t *base_post;
    uint16_t *base_p16;    /* u16 mirror of base_post (halves the rank
                            * walk's sequential read traffic); valid
                            * while every stored tix fits in 16 bits */
    int64_t base_p16_cap;
    int base_p16_ok;
    int64_t base_n, base_cap;
    int64_t *mid_starts;   /* v+1 */
    int32_t *mid_post;
    int64_t mid_n, mid_cap;
    int64_t *dw;
    int32_t *dt;
    int64_t dn, dcap;
    /* merge scratch */
    int32_t *wcnt;         /* v */
    int64_t *fpos;         /* v */
    int64_t *ns;           /* v+1 (new starts staging) */
    int32_t *merge_post;   /* merge output staging */
    int64_t merge_cap;
    /* centroid db view (grows across the whole run) */
    uint8_t *db;
    int64_t db_bytes, db_bytes_cap;
    int64_t *db_off;
    int64_t db_n, db_n_cap;
    /* rank scratch: u16 counts (a target's count is bounded by its
     * length; engine eligibility requires maxseqlength <= 65535).
     * A uint8_t count mirror was tried (r4) for short reads: paired
     * A/B showed byte RMW increments LOSE ~4% vs u16 on this uarch
     * despite half the traffic, so the u16 array stays. */
    uint16_t *u;
    uint32_t u_cap;
    uint8_t *seen;
    int64_t seen_cap;
    int64_t *uw;
    uint32_t uw_cap;
    uint32_t *cand_tix, *cand_cnt;
    uint32_t *stage_tix, *stage_cnt;
    uint32_t cand_cap;
    uint32_t *hist;
    uint32_t hist_cap;
    char *path;
    size_t path_cap;
} ClusterCtx;

ClusterCtx *cluster_ctx_create(void)
{
    ClusterCtx *cc = (ClusterCtx *)calloc(1, sizeof(ClusterCtx));
    cc->db_n_cap = 1024;
    cc->db_off = (int64_t *)calloc(cc->db_n_cap + 1, sizeof(int64_t));
    cc->db_bytes_cap = 1 << 18;
    cc->db = (uint8_t *)malloc(cc->db_bytes_cap);
    cc->dcap = CC_RAW_LIMIT + 4096;
    cc->dw = (int64_t *)malloc(cc->dcap * sizeof(int64_t));
    cc->dt = (int32_t *)malloc(cc->dcap * sizeof(int32_t));
    return cc;
}

void cluster_ctx_destroy(ClusterCtx *cc)
{
    if (!cc)
        return;
    free(cc->base_starts); free(cc->base_post); free(cc->base_p16);
    free(cc->mid_starts); free(cc->mid_post);
    free(cc->wcnt); free(cc->fpos); free(cc->ns); free(cc->merge_post);
    free(cc->dw); free(cc->dt); free(cc->db); free(cc->db_off);
    free(cc->u); free(cc->seen); free(cc->uw);
    free(cc->cand_tix); free(cc->cand_cnt);
    free(cc->stage_tix); free(cc->stage_cnt);
    free(cc->hist); free(cc->path);
    free(cc);
}

int64_t cluster_ctx_db_n(ClusterCtx *cc) { return cc->db_n; }

static void cc_index_init(ClusterCtx *cc, int64_t v)
{
    if (cc->v == v)
        return;
    cc->v = v;
    cc->base_starts = (int64_t *)calloc(v + 1, sizeof(int64_t));
    cc->mid_starts = (int64_t *)calloc(v + 1, sizeof(int64_t));
    cc->wcnt = (int32_t *)malloc(v * sizeof(int32_t));
    cc->fpos = (int64_t *)malloc(v * sizeof(int64_t));
    cc->ns = (int64_t *)malloc((v + 1) * sizeof(int64_t));
}

/* merge a CSR (starts/post) with per-word-counted raw pairs into the
 * staging buffers, then swap into (starts/post).  Stable: old row first,
 * then raw pairs in append order. */
static void cc_merge_into(ClusterCtx *cc, int64_t **pstarts,
                          int32_t **ppost, int64_t *pn, int64_t *pcap,
                          const int64_t *rw, const int32_t *rt,
                          int64_t rn)
{
    int64_t v = cc->v;
    memset(cc->wcnt, 0, (size_t)v * sizeof(int32_t));
    for (int64_t p = 0; p < rn; ++p)
        ++cc->wcnt[rw[p]];
    int64_t *old_starts = *pstarts;
    int32_t *old_post = *ppost;
    int64_t total = *pn + rn;
    if (total > cc->merge_cap) {
        free(cc->merge_post);
        cc->merge_cap = total * 2 + 4096;
        cc->merge_post = (int32_t *)malloc(cc->merge_cap *
                                           sizeof(int32_t));
    }
    int64_t *ns = cc->ns;
    ns[0] = 0;
    for (int64_t w = 0; w < v; ++w) {
        int64_t old_len = old_starts[w + 1] - old_starts[w];
        ns[w + 1] = ns[w] + old_len + cc->wcnt[w];
        if (old_len)
            memcpy(cc->merge_post + ns[w], old_post + old_starts[w],
                   (size_t)old_len * sizeof(int32_t));
        cc->fpos[w] = ns[w] + old_len;
    }
    for (int64_t p = 0; p < rn; ++p)
        cc->merge_post[cc->fpos[rw[p]]++] = rt[p];
    /* swap: staging becomes the tier; old post becomes staging */
    int32_t *tmp_post = old_post;
    int64_t tmp_cap = *pcap;
    *ppost = cc->merge_post;
    *pcap = cc->merge_cap;
    cc->merge_post = tmp_post;
    cc->merge_cap = tmp_cap;
    memcpy(old_starts, ns, (size_t)(v + 1) * sizeof(int64_t));
    *pn = total;
}

static void cc_flush_raw(ClusterCtx *cc)
{
    if (cc->dn == 0)
        return;
    cc_merge_into(cc, &cc->mid_starts, &cc->mid_post, &cc->mid_n,
                  &cc->mid_cap, cc->dw, cc->dt, cc->dn);
    cc->dn = 0;
    if (cc->mid_n > 65536 && cc->mid_n * 4 > cc->base_n) {
        /* fold mid into base: mid becomes the "raw" of a second merge,
         * but it is already word-grouped — reuse the pair merge by
         * expanding mid rows back to (word, tix) order via a walk */
        /* simple linear fold: new base row = base row + mid row */
        int64_t v = cc->v;
        int64_t total = cc->base_n + cc->mid_n;
        if (total > cc->merge_cap) {
            free(cc->merge_post);
            cc->merge_cap = total * 2 + 4096;
            cc->merge_post = (int32_t *)malloc(cc->merge_cap *
                                               sizeof(int32_t));
        }
        int64_t *ns = cc->ns;
        ns[0] = 0;
        for (int64_t w = 0; w < v; ++w) {
            int64_t bl = cc->base_starts[w + 1] - cc->base_starts[w];
            int64_t ml = cc->mid_starts[w + 1] - cc->mid_starts[w];
            ns[w + 1] = ns[w] + bl + ml;
            if (bl)
                memcpy(cc->merge_post + ns[w],
                       cc->base_post + cc->base_starts[w],
                       (size_t)bl * sizeof(int32_t));
            if (ml)
                memcpy(cc->merge_post + ns[w] + bl,
                       cc->mid_post + cc->mid_starts[w],
                       (size_t)ml * sizeof(int32_t));
        }
        int32_t *tmp_post = cc->base_post;
        int64_t tmp_cap = cc->base_cap;
        cc->base_post = cc->merge_post;
        cc->base_cap = cc->merge_cap;
        cc->merge_post = tmp_post;
        cc->merge_cap = tmp_cap;
        memcpy(cc->base_starts, ns, (size_t)(v + 1) * sizeof(int64_t));
        cc->base_n = total;
        memset(cc->mid_starts, 0, (size_t)(v + 1) * sizeof(int64_t));
        cc->mid_n = 0;
        /* refresh the u16 mirror (folds are rare: one pass amortizes
         * over the thousands of rank walks that read it) */
        if (cc->base_n > cc->base_p16_cap) {
            free(cc->base_p16);
            cc->base_p16_cap = cc->base_n * 2 + 4096;
            cc->base_p16 = (uint16_t *)malloc(
                (size_t)cc->base_p16_cap * sizeof(uint16_t));
        }
        cc->base_p16_ok = cc->base_p16 != NULL;
        if (cc->base_p16_ok) {
            const int32_t *bp = cc->base_post;
            uint16_t *m16 = cc->base_p16;
            int32_t any_big = 0;
            for (int64_t p = 0; p < cc->base_n; ++p) {
                any_big |= bp[p] >> 16;
                m16[p] = (uint16_t)bp[p];
            }
            if (any_big)
                cc->base_p16_ok = 0;
        }
    }
}

static void cc_alloc_rank(ClusterCtx *cc, uint32_t seq_count,
                          int64_t slot_count, uint32_t max_words)
{
    if (seq_count + 64 > cc->u_cap) {
        uint32_t cap = seq_count * 2 + 1024;
        free(cc->u);
        cc->u = (uint16_t *)calloc(cap, sizeof(uint16_t));
        free(cc->cand_tix);
        free(cc->cand_cnt);
        free(cc->stage_tix);
        free(cc->stage_cnt);
        cc->cand_tix = (uint32_t *)malloc(cap * sizeof(uint32_t));
        cc->cand_cnt = (uint32_t *)malloc(cap * sizeof(uint32_t));
        cc->stage_tix = (uint32_t *)malloc(cap * sizeof(uint32_t));
        cc->stage_cnt = (uint32_t *)malloc(cap * sizeof(uint32_t));
        cc->u_cap = cap;
        cc->cand_cap = cap;
    }
    if (slot_count > cc->seen_cap) {
        free(cc->seen);
        cc->seen = (uint8_t *)calloc((size_t)((slot_count + 7) / 8), 1);
        cc->seen_cap = slot_count;
    }
    if (max_words > cc->uw_cap) {
        free(cc->uw);
        cc->uw_cap = max_words * 2 + 64;
        cc->uw = (int64_t *)malloc(cc->uw_cap * sizeof(int64_t));
    }
    if (cc->hist_cap < 65536) {
        free(cc->hist);
        cc->hist_cap = 65536;
        cc->hist = (uint32_t *)calloc(cc->hist_cap, sizeof(uint32_t));
    }
}

static int64_t lower_bound64_e(const int64_t *w, int64_t n, int64_t key)
{
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (w[mid] < key)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

/* CompressPath (src/comppath.cpp): run-length MDI, count omitted when 1 */
static int64_t compress_path(const char *path, int64_t n, char *out)
{
    int64_t o = 0, i = 0;
    while (i < n) {
        char c = path[i];
        int64_t j = i;
        while (j < n && path[j] == c)
            ++j;
        int64_t cnt = j - i;
        if (cnt > 1)
            o += sprintf(out + o, "%lld", (long long)cnt);
        out[o++] = c;
        i = j;
    }
    return o;
}

/* walk + delta-tail + SetTopBump scan over a UTYPE-wide count array
 * (single uint16_t instantiation: a uint8_t tier measured ~4% slower
 * end-to-end — byte RMW increments don't pay for the halved traffic
 * on this uarch).  The restrict qualifiers matter: without them a
 * byte-typed count array may alias every other array and the walk
 * bounds reload per iteration. */
#define DEFINE_CC_RANK_CORE(SUFFIX, UTYPE)                                  \
static uint32_t cc_rank_core_##SUFFIX(                                      \
    ClusterCtx *cc, UTYPE *restrict u, uint32_t nuw, uint32_t seq_count,    \
    uint32_t bump_pct, uint32_t *maxv_io, uint32_t *nextv_io)               \
{                                                                           \
    /* restrict everywhere: UTYPE=uint8_t otherwise aliases every other */  \
    /* byte array, forcing bound reloads inside the walk loops */           \
    const int64_t *restrict bs = cc->base_starts;                           \
    const int32_t *restrict bp = cc->base_post;                             \
    const uint16_t *restrict bp16 = cc->base_p16_ok ? cc->base_p16 : NULL;  \
    const int64_t *restrict ms = cc->mid_starts;                            \
    const int32_t *restrict mp = cc->mid_post;                              \
    const int64_t *restrict uw = cc->uw;                                    \
    for (uint32_t k = 0; k < nuw; ++k) {                                    \
        int64_t w = uw[k];                                                  \
        if (k + 4 < nuw) {                                                  \
            int64_t wn = uw[k + 4];                                         \
            __builtin_prefetch(&bs[wn], 0, 1);                              \
            __builtin_prefetch(&ms[wn], 0, 1);                              \
        }                                                                   \
        if (k + 2 < nuw) {                                                  \
            int64_t wn = uw[k + 2];                                         \
            if (bp16)                                                       \
                __builtin_prefetch(&bp16[bs[wn]], 0, 1);                    \
            else                                                            \
                __builtin_prefetch(&bp[bs[wn]], 0, 1);                      \
            __builtin_prefetch(&mp[ms[wn]], 0, 1);                          \
        }                                                                   \
        if (bp16) {                                                         \
            for (int64_t p = bs[w]; p < bs[w + 1]; ++p)                     \
                ++u[bp16[p]];                                               \
        } else {                                                            \
            for (int64_t p = bs[w]; p < bs[w + 1]; ++p)                     \
                ++u[bp[p]];                                                 \
        }                                                                   \
        for (int64_t p = ms[w]; p < ms[w + 1]; ++p)                         \
            ++u[mp[p]];                                                     \
    }                                                                       \
    /* raw tail: bitmap scan */                                             \
    {                                                                       \
        const int64_t *restrict dw = cc->dw;                                \
        const int32_t *restrict dt = cc->dt;                                \
        const uint8_t *restrict seen = cc->seen;                            \
        int64_t dn = cc->dn;                                                \
        for (int64_t p = 0; p < dn; ++p) {                                  \
            int64_t w = dw[p];                                              \
            if (seen[w >> 3] & (1u << (w & 7)))                             \
                ++u[dt[p]];                                                 \
        }                                                                   \
    }                                                                       \
    for (uint32_t k = 0; k < nuw; ++k)                                      \
        cc->seen[uw[k] >> 3] = 0;                                           \
    /* SetTopBump: index-order scan with fused clear, blocked so the    */  \
    /* common no-op block (max below cur_min AND not exceeding the      */  \
    /* running max) is skipped after one vectorizable max-reduction.    */  \
    /* Emissions also fill the count-sort histogram inline.             */  \
    uint32_t n_cand = 0, max_u_seen = 0;                                    \
    uint32_t *restrict out_tix = cc->cand_tix;                              \
    uint32_t *restrict out_counts = cc->cand_cnt;                           \
    uint32_t *restrict hist = cc->hist;                                     \
    uint32_t maxv = 0, nextv = 0;                                           \
    enum { RBLK = 64 };                                                     \
    if (bump_pct != 0) {                                                    \
        uint32_t cur_min = 1;                                               \
        for (uint32_t t0b = 0; t0b < seq_count; ) {                         \
            uint32_t endb = t0b + RBLK <= seq_count ? t0b + RBLK            \
                                                    : seq_count;            \
            UTYPE bm = 0;                                                   \
            for (uint32_t i = t0b; i < endb; ++i)                           \
                bm = u[i] > bm ? u[i] : bm;                                 \
            if (bm == 0) {                                                  \
                t0b = endb;                                                 \
                continue;                                                   \
            }                                                               \
            if (bm <= max_u_seen && bm < cur_min) {                         \
                memset(u + t0b, 0, (endb - t0b) * sizeof(UTYPE));           \
                t0b = endb;                                                 \
                continue;                                                   \
            }                                                               \
            for (uint32_t t = t0b; t < endb; ++t) {                         \
                uint32_t v = u[t];                                          \
                u[t] = 0;                                                   \
                if (v > max_u_seen) {                                       \
                    if (v >= cur_min) {                                     \
                        out_tix[n_cand] = t;                                \
                        out_counts[n_cand++] = v;                           \
                        ++hist[v];                                          \
                        if (v > maxv) {                                     \
                            nextv = maxv;                                   \
                            maxv = v;                                       \
                        }                                                   \
                        uint32_t nm =                                       \
                            (uint32_t)((uint64_t)v * bump_pct / 100);       \
                        if (cur_min < nm && nm < max_u_seen)                \
                            cur_min = nm;                                   \
                    }                                                       \
                    max_u_seen = v;                                         \
                } else if (v >= cur_min) {                                  \
                    out_tix[n_cand] = t;                                    \
                    out_counts[n_cand++] = v;                               \
                    ++hist[v];                                              \
                    if (v > maxv) {                                         \
                        nextv = maxv;                                       \
                        maxv = v;                                           \
                    }                                                       \
                }                                                           \
            }                                                               \
            t0b = endb;                                                     \
        }                                                                   \
    } else {                                                                \
        for (uint32_t t0b = 0; t0b < seq_count; ) {                         \
            uint32_t endb = t0b + RBLK <= seq_count ? t0b + RBLK            \
                                                    : seq_count;            \
            UTYPE bm = 0;                                                   \
            for (uint32_t i = t0b; i < endb; ++i)                           \
                bm = u[i] > bm ? u[i] : bm;                                 \
            if (bm == 0) {                                                  \
                t0b = endb;                                                 \
                continue;                                                   \
            }                                                               \
            for (uint32_t t = t0b; t < endb; ++t) {                         \
                uint32_t v = u[t];                                          \
                u[t] = 0;                                                   \
                if (v >= 1) {                                               \
                    out_tix[n_cand] = t;                                    \
                    out_counts[n_cand++] = v;                               \
                    ++hist[v];                                              \
                    if (v > maxv) {                                         \
                        nextv = maxv;                                       \
                        maxv = v;                                           \
                    }                                                       \
                }                                                           \
            }                                                               \
            t0b = endb;                                                     \
        }                                                                   \
    }                                                                       \
    *maxv_io = maxv;                                                        \
    *nextv_io = nextv;                                                      \
    return n_cand;                                                          \
}

DEFINE_CC_RANK_CORE(u16, uint16_t)

/* rank one query against the C-owned 3-tier index; returns candidate
 * count in cc->cand_tix/cand_cnt (SetTopBump + CountSortOrderDesc
 * order, bit-identical to usort_rank_c) */
static uint32_t cc_rank(
    ClusterCtx *cc, const uint8_t *seq, int64_t L,
    const uint8_t *ctl, uint32_t alpha_size, uint32_t wlen,
    int64_t slot_count,
    uint32_t seq_count, uint32_t bump_pct, uint32_t max_emit,
    uint32_t *n_uw_out)
{
    if (seq_count == 0 || L < (int64_t)wlen)
        return 0;
    cc_alloc_rank(cc, seq_count, slot_count, (uint32_t)L);
    int64_t pow_w = 1;
    for (uint32_t k = 1; k < wlen; ++k)
        pow_w *= alpha_size;
    uint32_t nuw = 0;
    int64_t word = 0;
    uint32_t run = 0;
    for (int64_t i = 0; i < L; ++i) {
        uint8_t let = ctl[seq[i]];
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
            if (!(cc->seen[word >> 3] & (1u << (word & 7)))) {
                cc->seen[word >> 3] |= (uint8_t)(1u << (word & 7));
                cc->uw[nuw++] = word;
            }
        }
    }
    *n_uw_out = nuw;
    /* maxv/nextv track the count-sort's prefix-record NextValue while
     * emitting (saves a second pass over the candidate list) */
    uint32_t n_cand, maxv = 0, nextv = 0;
    n_cand = cc_rank_core_u16(cc, cc->u, nuw, seq_count, bump_pct,
                              &maxv, &nextv);
    uint32_t *out_tix = cc->cand_tix, *out_counts = cc->cand_cnt;
    uint32_t *hist = cc->hist;
    if (n_cand == 0)
        return 0;
    /* CountSortOrderDesc: stable desc with NextValue/2 cutoff
     * (maxv/nextv and the histogram were computed during the emission
     * scan; buckets below minv are filled too, which the placement
     * loops never read) */
    uint32_t minv = nextv / 2;
    /* partial count-sort: the caller consumes at most max_emit
     * candidates (maxaccepts+maxrejects bound), so only buckets down to
     * the bucket containing the max_emit-th candidate are placed; ties
     * in that bucket are kept in full (index-ascending), preserving the
     * exact CountSortOrderDesc prefix */
    uint32_t c_star = minv;
    uint32_t n_emit = 0;
    for (int64_t v = maxv; v >= (int64_t)minv; --v) {
        n_emit += hist[v];
        c_star = (uint32_t)v;
        if (max_emit && n_emit >= max_emit)
            break;
    }
    uint32_t off = 0;
    for (int64_t v = maxv; v >= (int64_t)c_star; --v) {
        uint32_t c = hist[v];
        hist[v] = off;
        off += c;
    }
    /* stable placement into scratch, then copy the emitted prefix */
    uint32_t *stix = cc->stage_tix, *scnt = cc->stage_cnt;
    for (uint32_t i = 0; i < n_cand; ++i) {
        uint32_t v = out_counts[i];
        if (v < c_star)
            continue;
        uint32_t pos = hist[v]++;
        stix[pos] = out_tix[i];
        scnt[pos] = v;
    }
    memcpy(out_tix, stix, n_emit * sizeof(uint32_t));
    memcpy(out_counts, scnt, n_emit * sizeof(uint32_t));
    /* restore hist to all-zero for the next call (every filled bucket
     * is <= maxv; buckets in [c_star, maxv] hold placement offsets) */
    memset(hist, 0, (maxv + 1) * sizeof(uint32_t));
    return n_emit;
}

/* ---------------------------------------------------------------- */
/* UCHIME GetLeftRight (src/deparser.cpp:84-204): per-parent left/right
 * diff positions over a global alignment path, including the TermGapsOk
 * terminal-deletion gate.  out = {diffs, pos_l0, pos_l1, pos_r0,
 * pos_r1}; 0xFFFFFFFF = undefined.  Returns 0 ok, 1 = TermGapsOk
 * failed (all outputs UINT_MAX). */
int uchime_left_right_c(const uint8_t *q, const uint8_t *t,
                        const char *path, int64_t n,
                        const uint8_t *match_mx, int64_t max_term_d,
                        int64_t *out)
{
    const int64_t UMAX = 0xFFFFFFFFll;
    out[0] = out[1] = out[2] = out[3] = out[4] = UMAX;
    int64_t i = 0;
    while (i < n && path[i] == 'D') {
        if (i > max_term_d)
            return 1;
        ++i;
    }
    i = 0;
    while (i < n && path[n - i - 1] == 'D') {
        if (i > max_term_d)
            return 1;
        ++i;
    }
    int64_t col_lo = UMAX, col_hi = UMAX;
    for (int64_t col = 0; col < n; ++col)
        if (path[col] == 'M') {
            if (col_lo == UMAX)
                col_lo = col;
            col_hi = col;
        }
    int64_t qpos = 0, tpos = 0, diffs = 0;
    int64_t pos_l0 = UMAX, pos_l1 = UMAX;
    for (int64_t col = 0; col < n; ++col) {
        char c = path[col];
        if (c == 'M') {
            if (!match_mx[(size_t)q[qpos] * 256 + t[tpos]])
                ++diffs;
            if (diffs == 0)
                pos_l0 = qpos;
            else if (diffs == 1)
                pos_l1 = qpos;
            ++qpos;
            ++tpos;
        } else {
            if (c == 'D')
                ++qpos;
            if (col_lo != UMAX && col_lo <= col && col <= col_hi) {
                ++diffs;
                if (diffs == 0)
                    pos_l0 = qpos;
                else if (diffs == 1)
                    pos_l1 = qpos;
            }
            if (c == 'I')
                ++tpos;
        }
    }
    int64_t diffs_r = 0, pos_r0 = UMAX, pos_r1 = UMAX;
    for (int64_t k = 0; k < n; ++k) {
        int64_t col = n - k - 1;
        char c = path[col];
        if (c == 'M') {
            --qpos;
            --tpos;
            if (!match_mx[(size_t)q[qpos] * 256 + t[tpos]])
                ++diffs_r;
            if (diffs_r == 0)
                pos_r0 = qpos;
            else if (diffs_r == 1)
                pos_r1 = qpos;
        } else {
            if (c == 'D')
                --qpos;
            else if (c == 'I')
                --tpos;
            if (col_lo != UMAX && col_lo <= col && col <= col_hi) {
                ++diffs_r;
                if (diffs_r == 0)
                    pos_r0 = qpos;
                else if (diffs_r == 1)
                    pos_r1 = qpos;
            }
        }
    }
    out[0] = diffs;
    out[1] = pos_l0;
    out[2] = pos_l1;
    out[3] = pos_r0;
    out[4] = pos_r1;
    return 0;
}

/* ---------------------------------------------------------------- */
/* SINTAX bootstrap loop (src/sintaxsearcher.cpp:84-187): boots
 * iterations, each sampling m query unique words with the private LCG,
 * scatter-adding their posting rows into U, and taking the max target
 * with a random tie-break from the reference's global lagged-MWC RNG
 * (src/myutils.cpp:1757-1838; 5-word state threaded through grand_x).
 * Writes each boot's winning target index and word count. */
static inline uint64_t sintax_grand_inc(uint64_t *x)
{
    uint64_t s = 2111111111ull * x[3] + 1492ull * x[2] + 1776ull * x[1] +
                 5115ull * x[0] + x[4];
    x[3] = x[2];
    x[2] = x[1];
    x[1] = x[0];
    x[4] = (s >> 32) & 0xFFFFFFFFull;
    x[0] = s & 0xFFFFFFFFull;
    return x[0];
}

/* The next n draws of that RNG (GlobalRand.randu32), in order, into out;
 * grand_x is left advanced in place.  The card path's tie-break draws of a
 * window (amplicon/sintax_device.py). */
void sintax_grand_draws_c(uint64_t *grand_x, uint32_t *out, int64_t n)
{
    uint64_t x[5];
    memcpy(x, grand_x, sizeof x);
    for (int64_t i = 0; i < n; ++i)
        out[i] = (uint32_t)sintax_grand_inc(x);
    memcpy(grand_x, x, sizeof x);
}

/* QuickSortOrderDesc (reference sort.h model): Hoare partition around
 * the middle element; identical swap sequence => identical tie order. */
static void sx_qsort_desc(const int32_t *vals, int32_t *order,
                          int64_t left, int64_t right)
{
    int64_t i = left, j = right;
    int32_t pivot = vals[order[(left + right) / 2]];
    while (i <= j) {
        while (vals[order[i]] > pivot)
            ++i;
        while (vals[order[j]] < pivot)
            --j;
        if (i <= j) {
            int32_t t = order[i];
            order[i] = order[j];
            order[j] = t;
            ++i;
            --j;
        }
    }
    if (left < j)
        sx_qsort_desc(vals, order, left, j);
    if (i < right)
        sx_qsort_desc(vals, order, i, right);
}

/* The winners' tax tally of one strand (CountMapToVecs): each boot's
 * winning target's tax id counted in ascending tax-id order (the map's
 * lexicographic order: the caller assigns ids lexicographically), then
 * QuickSortOrderDesc over the counts, so ids/cnts come out in the final
 * order.  boots <= a few hundred, so an insertion of the distinct ids is
 * cheap.  Returns the number of distinct tax ids. */
static int64_t sx_tally(const int32_t *tax_id, const int32_t *winners,
                        int boots, int32_t *ids, int32_t *cnts)
{
    int64_t ntax = 0;
    for (int boot = 0; boot < boots; ++boot) {
        int32_t tx = tax_id[winners[boot]];
        int64_t lo = 0, hi = ntax;
        while (lo < hi) {                /* lower_bound */
            int64_t mid = (lo + hi) >> 1;
            if (ids[mid] < tx)
                lo = mid + 1;
            else
                hi = mid;
        }
        if (lo < ntax && ids[lo] == tx) {
            ++cnts[lo];
        } else {
            for (int64_t k = ntax; k > lo; --k) {
                ids[k] = ids[k - 1];
                cnts[k] = cnts[k - 1];
            }
            ids[lo] = tx;
            cnts[lo] = 1;
            ++ntax;
        }
    }
    if (ntax > 1) {
        int32_t stack_buf[3 * 256];
        int32_t *buf = ntax <= 256 ? stack_buf
            : (int32_t *)malloc((size_t)ntax * 3 * sizeof(int32_t));
        int32_t *ord = buf, *tmp = buf + ntax;
        for (int64_t k = 0; k < ntax; ++k)
            ord[k] = (int32_t)k;
        sx_qsort_desc(cnts, ord, 0, ntax - 1);
        for (int64_t k = 0; k < ntax; ++k) {
            tmp[k] = ids[ord[k]];
            tmp[ntax + k] = cnts[ord[k]];
        }
        memcpy(ids, tmp, (size_t)ntax * sizeof(int32_t));
        memcpy(cnts, tmp + ntax, (size_t)ntax * sizeof(int32_t));
        if (buf != stack_buf)
            free(buf);
    }
    return ntax;
}

/* The card path's tally and strand vote of a window
 * (amplicon/sintax_device.py:SintaxTorchClassifier.tally): winners and
 * tops (n_jobs, boots) as the boot step returns them, job_map (n_q, 2) the
 * job of each query's forward and reverse strand, -1 where it has none.
 * A strand's top word count is its boots' largest (0 without a job); the
 * forward strand wins ties, and the '*'-row check reads the last
 * classified strand's count, as in sintax_window_c.  Only the winning
 * strand is tallied, into the same outputs as sintax_window_c's. */
int64_t sintax_tally_window_c(
    const int32_t *winners, const int32_t *tops, int boots,
    const int32_t *job_map, int64_t n_q, int strand_both,
    const int32_t *tax_id,
    int32_t *out_ntax, int32_t *out_ids, int32_t *out_cnts,
    int32_t *out_twc_last, uint8_t *out_strand)
{
    for (int64_t qi = 0; qi < n_q; ++qi) {
        int32_t twc_s[2] = {0, 0};
        for (int s = 0; s < (strand_both ? 2 : 1); ++s) {
            int32_t j = job_map[2 * qi + s];
            if (j < 0)
                continue;
            const int32_t *tp = tops + (size_t)j * boots;
            for (int b = 0; b < boots; ++b)
                if (tp[b] > twc_s[s])
                    twc_s[s] = tp[b];
        }
        int use_fwd = twc_s[0] >= twc_s[1];
        int32_t j = job_map[2 * qi + (use_fwd ? 0 : 1)];
        out_ntax[qi] = j < 0 ? 0 : (int32_t)sx_tally(
            tax_id, winners + (size_t)j * boots, boots,
            out_ids + (size_t)qi * boots, out_cnts + (size_t)qi * boots);
        out_twc_last[qi] = strand_both ? twc_s[1] : twc_s[0];
        out_strand[qi] = use_fwd ? '+' : '-';
    }
    return n_q;
}

/* Lemire exact fastmod: a % d without a hardware divide. */
static inline uint32_t sx_fastmod(uint32_t a, uint64_t magic, uint32_t d)
{
    uint64_t lowbits = magic * a;
    return (uint32_t)(((unsigned __int128)lowbits * d) >> 64);
}

int64_t sintax_boots_c(
    EngineScratch *es,
    const int64_t *uw, int64_t nuw,
    const int64_t *starts, const int32_t *postings, uint32_t seq_count,
    int boots, int m, uint32_t r0, uint64_t *grand_x,
    const int32_t *tax_id,
    int32_t *out_top_ti, int32_t *out_top_u,
    int32_t *out_tax_ids, int32_t *out_tax_cnts, int32_t *out_twc)
{
    if (seq_count == 0 || nuw == 0)
        return 0;
    if ((size_t)seq_count + 64 > es->stage_cap) {
        free(es->stage_tix);
        free(es->stage_cnt);
        es->stage_cap = (size_t)seq_count * 2 + 1024;
        es->stage_tix = (uint32_t *)malloc(es->stage_cap *
                                           sizeof(uint32_t));
        es->stage_cnt = (uint32_t *)malloc(es->stage_cap *
                                           sizeof(uint32_t));
    }
    /* compact per-query copy of the query words' postings rows: the
     * boots sample only these nuw rows, and reading them from the full
     * index is ~2 cache misses per pick (starts[] is 512 KB, postings
     * is scattered); one gathering pass makes every boot L1-resident */
    if ((size_t)nuw + 1 > es->sx_off_cap) {
        free(es->sx_off);
        es->sx_off_cap = (size_t)nuw * 2 + 64;
        es->sx_off = (int64_t *)malloc(es->sx_off_cap * sizeof(int64_t));
    }
    int64_t total = 0;
    for (int64_t i = 0; i < nuw; ++i) {
        es->sx_off[i] = total;
        total += starts[uw[i] + 1] - starts[uw[i]];
    }
    es->sx_off[nuw] = total;
    if ((size_t)total > es->sx_data_cap) {
        free(es->sx_data);
        es->sx_data_cap = (size_t)total * 2 + 256;
        es->sx_data = (int32_t *)malloc(es->sx_data_cap *
                                        sizeof(int32_t));
    }
    for (int64_t i = 0; i < nuw; ++i) {
        int64_t s0 = starts[uw[i]];
        int64_t len = starts[uw[i] + 1] - s0;
        memcpy(es->sx_data + es->sx_off[i], postings + s0,
               (size_t)len * sizeof(int32_t));
    }
    const int64_t *roff = es->sx_off;
    const int32_t *rdat = es->sx_data;

    uint32_t *u = es->stage_cnt;          /* zeroed between boots via
                                           * the touched list */
    uint32_t *touched = es->stage_tix;
    memset(u, 0, (size_t)seq_count * sizeof(uint32_t));
    uint32_t r = r0;
    uint32_t nuw32 = (uint32_t)nuw;
    uint64_t magic = 0xFFFFFFFFFFFFFFFFull / nuw32 + 1;
    int32_t twc = 0;
    uint32_t wi_buf[256];
    uint32_t *wis = m <= 256 ? wi_buf
        : (uint32_t *)malloc((size_t)m * sizeof(uint32_t));
    for (int boot = 0; boot < boots; ++boot) {
        uint32_t nt = 0;
        /* draw the boot's picks first: decouples the serial LCG/fastmod
         * chain from the memory-bound row processing below */
        for (int k = 0; k < m; ++k) {
            r = 1664525u * r + 1013904223u;
            wis[k] = (nuw32 == 1) ? 0 : sx_fastmod(r, magic, nuw32);
        }
        for (int k = 0; k < m; ++k) {
            uint32_t wi = wis[k];
            for (int64_t p = roff[wi]; p < roff[wi + 1]; ++p) {
                uint32_t t = (uint32_t)rdat[p];
                if (t < seq_count) {
                    /* branchless first-touch append: the ~50%-taken
                     * branch here mispredicts constantly */
                    uint32_t v = u[t];
                    touched[nt] = t;
                    nt += (v == 0);
                    u[t] = v + 1;
                }
            }
        }
        uint32_t top_u = 0, n_top = 0;
        for (uint32_t k = 0; k < nt; ++k) {
            uint32_t v = u[touched[k]];
            if (v > top_u) {
                top_u = v;
                n_top = 1;
            } else if (v == top_u) {
                ++n_top;
            }
        }
        uint32_t rr = (uint32_t)sintax_grand_inc(grand_x);
        uint32_t top_ti;
        if (top_u == 0) {
            /* no shared words: every target ties at zero */
            top_ti = rr % seq_count;
        } else {
            /* ties must be resolved in INDEX order (the reference
             * collects them by an ascending scan of U): pick the
             * want-th smallest touched index with u == top_u */
            uint32_t want = rr % n_top;
            top_ti = 0;
            if (n_top == 1) {
                for (uint32_t k = 0; k < nt; ++k)
                    if (u[touched[k]] == top_u) {
                        top_ti = touched[k];
                        break;
                    }
            } else if (n_top <= 16) {
                /* sparse ties: collect tied indexes, insertion-sort
                 * ascending (reference tie order), pick the want-th */
                uint32_t tied[16];
                uint32_t mth = 0;
                for (uint32_t k = 0; k < nt; ++k) {
                    uint32_t t = touched[k];
                    if (u[t] == top_u) {
                        uint32_t pos = mth;
                        while (pos > 0 && tied[pos - 1] > t) {
                            tied[pos] = tied[pos - 1];
                            --pos;
                        }
                        tied[pos] = t;
                        ++mth;
                    }
                }
                top_ti = tied[want];
            } else {
                /* dense ties: one ascending scan of u[] — exactly the
                 * reference's tie-collection order */
                uint32_t step = 0;
                uint32_t chosen = 0xFFFFFFFFu;
                for (uint32_t t = 0; t < seq_count; ++t) {
                    if (u[t] == top_u && step++ == want) {
                        chosen = t;
                        break;
                    }
                }
                top_ti = chosen;
            }
        }
        out_top_ti[boot] = (int32_t)top_ti;
        out_top_u[boot] = (int32_t)top_u;
        if ((int32_t)top_u > twc)
            twc = (int32_t)top_u;
        for (uint32_t k = 0; k < nt; ++k)     /* clear for next boot */
            u[touched[k]] = 0;
    }
    if (wis != wi_buf)
        free(wis);
    *out_twc = twc;
    return sx_tally(tax_id, out_top_ti, boots, out_tax_ids, out_tax_cnts);
}

/* Host fallback for device-emitted holes: banded/full NW per hole with
 * the hole's terminal-penalty class, paths concatenated into out_buf
 * with out_off[h..h+1] offsets.  Returns total bytes, or -1 if out_cap
 * is too small (caller grows and retries).  Used when a hole batch is
 * too small to amortize a device dispatch. */
int64_t align_holes_c(
    EngineScratch *es, const GapParams *gp, const float *sub_mx,
    uint32_t band_radius,
    const uint8_t *jbuf, const uint8_t *db,
    const int64_t *hole_aoff, const int64_t *hole_boff,
    const int32_t *hole_alen, const int32_t *hole_blen,
    const uint8_t *hole_cls, const uint8_t *hole_a_is_query,
    int64_t n_holes,
    char *out_buf, int64_t *out_off, int64_t out_cap)
{
    int64_t pos = 0;
    out_off[0] = 0;
    for (int64_t h = 0; h < n_holes; ++h) {
        const uint8_t *a = (hole_a_is_query && !hole_a_is_query[h])
                               ? db + hole_aoff[h]
                               : jbuf + hole_aoff[h];
        const uint8_t *b = db + hole_boff[h];
        uint32_t la = (uint32_t)hole_alen[h];
        uint32_t lb = (uint32_t)hole_blen[h];
        if (pos + la + lb + 2 > out_cap)
            return -1;
        GapParams lp;
        uint8_t c = hole_cls[h];
        hole_params(gp, c & 1, (c >> 1) & 1, (c >> 2) & 1, (c >> 3) & 1,
                    &lp);
        eng_alloc_dp(es, la, lb);
        float score;
        int n;
        if (band_radius == 0) {
            n = nw_full(a, la, b, lb, &lp, sub_mx, es->tb, es->mrow,
                        es->drow, out_buf + pos, &score);
        } else {
            uint32_t dlo, dhi;
            eng_band_range(la, lb, band_radius, &dlo, &dhi);
            n = nw_band(a, la, b, lb, dlo, dhi, &lp, sub_mx, es->tb,
                        es->mrow, es->drow, out_buf + pos, &score);
        }
        if (n < 0)
            return -2;
        pos += n;
        out_off[h + 1] = pos;
    }
    return pos;
}

/* process a window of the greedy loop; returns the query index AFTER
 * the last fully processed query (the caller resumes there after
 * folding admissions into the frozen tiers and resetting the delta).
 * Outputs (per query q in [start_q, ret)):
 *   out_assign[q]  cluster index joined or created
 *   out_admit[q]   1 if q became a new centroid
 *   out_hit_off[q], out_hit_off[q+1]: hits in the flat hit arrays
 * Flat hits: tix / rc / pct (double) / compressed path bytes.
 * Returns -1 if the per-query output capacity is too small to even
 * process one query (caller grows and retries). */
int64_t cluster_greedy_c(
    ClusterCtx *cc, HSPFinderC *hf, AlignScratch *as, EngineScratch *es,
    const GapParams *gp, const float *sub_mx, const byte *match_mx,
    const byte *id_mx, const byte *to_upper,
    uint32_t band_radius, uint32_t min_hsp_len, float min_hsp_fract,
    float min_hsp_score, float xdrop_g, int full_dp_always,
    int fail_if_no_hsps,
    const uint8_t *ctl_rank, uint32_t alpha_size, uint32_t wlen,
    int64_t slot_count,
    uint32_t bump_pct,
    float min_id, float max_id, int has_max_id,
    int32_t maxaccepts, int32_t maxrejects,
    const uint8_t *qbuf, const int64_t *q_off, int strand_both,
    int64_t n_queries, int64_t start_q,
    int32_t *out_assign, uint8_t *out_admit, int64_t *out_hit_off,
    int32_t *hit_tix, uint8_t *hit_rc, double *hit_pct,
    float *hit_fract /* float32 score for top-hit/sort tie rules */,
    int64_t *hit_cpath_off, char *cpath_buf, int64_t cpath_cap,
    int64_t max_hits,
    int64_t *inout_counters /* [n_hits, cpath_pos] resume state */)
{
    int jobs_per = strand_both ? 2 : 1;
    int64_t n_hits = inout_counters[0];
    int64_t cpos = inout_counters[1];
    cc_index_init(cc, slot_count);
    for (int64_t q = start_q; q < n_queries; ++q) {
        int64_t q_len0 = q_off[q * jobs_per + 1] - q_off[q * jobs_per];
        /* output capacity: worst case hits this query */
        int64_t max_q_hits = (int64_t)maxaccepts * jobs_per;
        if (n_hits + max_q_hits > max_hits ||
            cpos + 2 * (q_len0 + 4096) > cpath_cap)
            return (q > start_q) ? q : -1;

        out_hit_off[q] = n_hits;
        /* hits of this query: tix/rc/pct/path kept; fractid as f32 for
         * the top-hit rule */
        int64_t q_hit_base = n_hits;
        for (int s = 0; s < jobs_per; ++s) {
            int64_t j = q * jobs_per + s;
            const uint8_t *seq = qbuf + q_off[j];
            int64_t L = q_off[j + 1] - q_off[j];
            uint32_t nuw = 0;
            uint32_t max_emit = (maxaccepts > 0 && maxrejects > 0)
                ? (uint32_t)(maxaccepts + maxrejects) : 0;
            uint32_t n_cand = cc_rank(
                cc, seq, L, ctl_rank, alpha_size, wlen, slot_count,
                (uint32_t)cc->db_n, bump_pct, max_emit, &nuw);
            if (n_cand == 0)
                continue;
            hsp_set_a(hf, seq, (uint32_t)L);
            int32_t acc = 0, rej = 0;
            for (uint32_t k = 0; k < n_cand; ++k) {
                uint32_t t = cc->cand_tix[k];
                const uint8_t *tseq = cc->db + cc->db_off[t];
                uint32_t tl = (uint32_t)(cc->db_off[t + 1] - cc->db_off[t]);
                hsp_set_b(hf, tseq, tl);
                size_t need = (size_t)(L + tl + 2);
                if (need > cc->path_cap) {
                    free(cc->path);
                    cc->path_cap = 2 * need;
                    cc->path = (char *)malloc(cc->path_cap);
                }
                float fract_unused;
                int n = global_align_c(hf, as, gp, match_mx, band_radius,
                                       min_hsp_len, min_hsp_fract,
                                       min_hsp_score, xdrop_g,
                                       full_dp_always, fail_if_no_hsps,
                                       cc->path, &fract_unused);
                int accept = 0;
                double fract = 0.0;
                if (n > 0) {
                    int64_t stq[10];
                    int rc2 = path_stats_c((const uint8_t *)cc->path, n,
                                           seq, tseq, 0, 0, id_mx,
                                           to_upper, stq);
                    if (rc2 == 0) {
                        fract = (double)stq[6] /
                                (double)(stq[1] - stq[0] + 1);
                        accept = !(fract < (double)min_id);
                        if (accept && has_max_id &&
                            fract > (double)max_id)
                            accept = 0;
                    }
                }
                if (accept) {
                    hit_tix[n_hits] = (int32_t)t;
                    hit_rc[n_hits] = (uint8_t)s;
                    hit_pct[n_hits] = 100.0 * fract;
                    hit_fract[n_hits] = (float)fract;
                    int64_t cl = compress_path(cc->path, n,
                                               cpath_buf + cpos);
                    cpos += cl;
                    hit_cpath_off[n_hits + 1] = cpos;
                    ++n_hits;
                    ++acc;
                    if (maxaccepts > 0 && acc >= maxaccepts)
                        break;
                } else {
                    ++rej;
                    if (maxrejects > 0 && rej >= maxrejects)
                        break;
                }
            }
        }
        /* top hit: strict > on float32 fract-id, tie -> lowest tix
         * (HitMgr::GetTopHit) */
        if (n_hits > q_hit_base) {
            int64_t best = q_hit_base;
            float bs = hit_fract[best];
            int32_t bt = hit_tix[best];
            for (int64_t h = q_hit_base + 1; h < n_hits; ++h) {
                float sc = hit_fract[h];
                if (sc > bs || (sc == bs && hit_tix[h] < bt)) {
                    best = h;
                    bs = sc;
                    bt = hit_tix[h];
                }
            }
            out_assign[q] = hit_tix[best];
            out_admit[q] = 0;
        } else {
            /* admit as centroid ci = db_n; fwd-strand sequence */
            const uint8_t *seq = qbuf + q_off[q * jobs_per];
            int64_t L = q_len0;
            int64_t ci = cc->db_n;
            if (cc->db_n + 1 >= cc->db_n_cap) {
                cc->db_n_cap *= 2;
                cc->db_off = (int64_t *)realloc(
                    cc->db_off, (cc->db_n_cap + 1) * sizeof(int64_t));
            }
            if (cc->db_bytes + L > cc->db_bytes_cap) {
                while (cc->db_bytes + L > cc->db_bytes_cap)
                    cc->db_bytes_cap *= 2;
                cc->db = (uint8_t *)realloc(cc->db, cc->db_bytes_cap);
            }
            memcpy(cc->db + cc->db_bytes, seq, (size_t)L);
            cc->db_off[ci] = cc->db_bytes;
            cc->db_bytes += L;
            cc->db_off[ci + 1] = cc->db_bytes;
            cc->db_n = ci + 1;
            /* index the centroid's unique words into the delta tier
             * (AddSeqNoncoded over unique target words) */
            cc_alloc_rank(cc, (uint32_t)cc->db_n, slot_count,
                          (uint32_t)L);
            int64_t pow_w = 1;
            for (uint32_t k = 1; k < wlen; ++k)
                pow_w *= alpha_size;
            uint32_t nw = 0;
            int64_t word = 0;
            uint32_t run = 0;
            for (int64_t i = 0; i < L; ++i) {
                uint8_t let = ctl_rank[seq[i]];
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
                    if (!(cc->seen[word >> 3] & (1u << (word & 7)))) {
                        cc->seen[word >> 3] |= (uint8_t)(1u << (word & 7));
                        cc->uw[nw++] = word;
                    }
                }
            }
            for (uint32_t k = 0; k < nw; ++k)
                cc->seen[cc->uw[k] >> 3] = 0;
            if (cc->dn + nw > cc->dcap) {
                while (cc->dn + nw > cc->dcap)
                    cc->dcap *= 2;
                cc->dw = (int64_t *)realloc(cc->dw,
                                            cc->dcap * sizeof(int64_t));
                cc->dt = (int32_t *)realloc(cc->dt,
                                            cc->dcap * sizeof(int32_t));
            }
            for (uint32_t k = 0; k < nw; ++k) {
                cc->dw[cc->dn] = cc->uw[k];
                cc->dt[cc->dn] = (int32_t)ci;
                ++cc->dn;
            }
            if (cc->dn >= CC_RAW_LIMIT)
                cc_flush_raw(cc);
            out_assign[q] = (int32_t)ci;
            out_admit[q] = 1;
        }
        out_hit_off[q + 1] = n_hits;
        inout_counters[0] = n_hits;
        inout_counters[1] = cpos;
    }
    return n_queries;
}

/* Splice + stats + accept/terminate replay.
 *
 * Pairs are grouped by job in candidate order (the same pair arrays that
 * chain_batch_c consumed).  Per job, pairs are consumed until the
 * terminator fires (maxaccepts/maxrejects) exactly as the serial loop
 * (src/terminator.cpp:64-90 with counter defaults).  Accepted hits are
 * appended to the hit arrays with their path and the path_stats_c
 * 10-stat vector.
 *
 * job_state: (n_jobs, 3) int32 [accepts, rejects, done] carried across
 * rounds.  out_used[j] = pairs consumed from this batch.
 * Returns hit count, or -1 if hit_path capacity is too small. */
int64_t finish_replay_c(
    EngineScratch *es,
    const uint8_t *status,
    const uint8_t *seg_kind, const int64_t *seg_val, const int64_t *seg_val2,
    const int64_t *pair_seg_off,
    const int32_t *pair_j, const uint32_t *pair_t, int64_t n_pairs,
    const char *lit_buf,
    const char *hole_paths, const int64_t *hole_off,
    const uint8_t *jbuf, const int64_t *j_off,
    const uint8_t *db, const int64_t *db_off, const int64_t *db_len,
    const uint8_t *id_mx256, const uint8_t *to_upper,
    float min_id, float max_id, int has_max_id,
    int32_t maxaccepts, int32_t maxrejects,
    int32_t *job_state,
    int32_t *out_used,
    int32_t *hit_job, uint32_t *hit_tix,
    char *hit_paths, int64_t *hit_path_off, int64_t hit_path_cap,
    int64_t *hit_stats, int64_t max_hits)
{
    int64_t n_hits = 0, hp_pos = 0;
    hit_path_off[0] = 0;
    for (int64_t p = 0; p < n_pairs; ++p) {
        int32_t j = pair_j[p];
        int32_t *st = job_state + 3 * j;
        if (st[2]) {        /* job already terminated: skip */
            continue;
        }
        out_used[j] += 1;
        int accept = 0;
        if (status[p] == PAIR_PLAN) {
            /* splice the path */
            uint32_t t = pair_t[p];
            const uint8_t *a = jbuf + j_off[j];
            const uint8_t *b = db + db_off[t];
            int64_t la = j_off[j + 1] - j_off[j];
            int64_t lb = db_len[t];
            eng_alloc_path(es, (size_t)(la + lb + 2));
            char *pp = es->path;
            for (int64_t s = pair_seg_off[p]; s < pair_seg_off[p + 1];
                 ++s) {
                switch (seg_kind[s]) {
                case SEG_M:
                    memset(pp, 'M', (size_t)seg_val[s]);
                    pp += seg_val[s];
                    break;
                case SEG_I:
                    memset(pp, 'I', (size_t)seg_val[s]);
                    pp += seg_val[s];
                    break;
                case SEG_D:
                    memset(pp, 'D', (size_t)seg_val[s]);
                    pp += seg_val[s];
                    break;
                case SEG_LIT:
                    memcpy(pp, lit_buf + seg_val[s], (size_t)seg_val2[s]);
                    pp += seg_val2[s];
                    break;
                case SEG_HOLE: {
                    int64_t h = seg_val[s];
                    int64_t hn = hole_off[h + 1] - hole_off[h];
                    memcpy(pp, hole_paths + hole_off[h], (size_t)hn);
                    pp += hn;
                    break;
                }
                }
            }
            int64_t n_col = pp - es->path;
            int64_t stats[10];
            int rc = path_stats_c((const uint8_t *)es->path, n_col, a, b,
                                  0, 0, id_mx256, to_upper, stats);
            if (rc == 0) {
                /* GetFractId: id M-cols / (last_m - first_m + 1) */
                double fract = (double)stats[6] /
                               (double)(stats[1] - stats[0] + 1);
                accept = !(fract < (double)min_id);
                if (accept && has_max_id && fract > (double)max_id)
                    accept = 0;
                if (accept) {
                    if (n_hits >= max_hits ||
                        hp_pos + n_col > hit_path_cap)
                        return -1;
                    hit_job[n_hits] = j;
                    hit_tix[n_hits] = t;
                    memcpy(hit_paths + hp_pos, es->path, (size_t)n_col);
                    hp_pos += n_col;
                    memcpy(hit_stats + 10 * n_hits, stats,
                           10 * sizeof(int64_t));
                    ++n_hits;
                    hit_path_off[n_hits] = hp_pos;
                }
            }
        }
        if (accept) {
            st[0] += 1;
            if (maxaccepts > 0 && st[0] >= maxaccepts)
                st[2] = 1;
        } else {
            st[1] += 1;
            if (maxrejects > 0 && st[1] >= maxrejects)
                st[2] = 1;
        }
    }
    return n_hits;
}

/* ---- uchime3 DeParser::ParseLo scan loop (src/deparser.cpp:206-330) -----
 * Fuses per-target global alignment + GetLeftRight + best-position
 * tracking into one call, eliminating per-target ctypes round-trips.
 * Semantics mirror the Python loop in amplicon/uchime.py _parse_lo:
 *   - query is set once (hsp_set_a), each target via hsp_set_b
 *   - trackers use uint32 arithmetic with 0xFFFFFFFF sentinels
 *   - early break once diffs_qt == 0 (after tracker updates)
 * Paths for all scanned targets are stored in paths_buf (NUL-free,
 * delimited by path_offs) so the caller can fetch the bimera winners.
 * Returns n_done (#targets scanned) or a negative error:
 *   -9 paths_buf too small, -10 alignment failed.  state_out[10]:
 *   top, diffs_qt, best_l0, pos_l0, best_r0, pos_r0,
 *   best_l1, pos_l1, best_r1, pos_r1. */
extern int uchime_left_right_c(const uint8_t *q, const uint8_t *t,
                               const char *path, int64_t n,
                               const uint8_t *match_mx, int64_t max_term_d,
                               int64_t *out);

int64_t uchime_parse_lo_c(HSPFinderC *hf, AlignScratch *s, const GapParams *gp,
                          const byte *match_u8,
                          int64_t band_radius, int64_t min_global_hsp_length,
                          double min_hsp_fract_id, double min_hsp_score,
                          double xdrop_g,
                          const byte *q, int64_t lq,
                          const byte *cat, const int64_t *offs,
                          int64_t n_targets,
                          char *paths_buf, int64_t paths_cap,
                          int64_t *path_offs, int64_t *state_out)
{
    const uint32_t UMAX = 0xFFFFFFFFu;
    uint32_t top = UMAX, dqt = UMAX;
    uint32_t bl0 = UMAX, br0 = UMAX, bl1 = UMAX, br1 = UMAX;
    uint32_t pbl0 = 0, pbl1 = 0, pbr0 = UMAX, pbr1 = UMAX;

    hsp_set_a(hf, q, (uint32_t)lq);
    int64_t cur = 0;
    path_offs[0] = 0;
    int64_t ti = 0;
    for (; ti < n_targets; ++ti) {
        const byte *t = cat + offs[ti];
        int64_t lt = offs[ti + 1] - offs[ti];
        if (cur + lq + lt + 2 > paths_cap)
            return -9;
        hsp_set_b(hf, t, (uint32_t)lt);
        float fr = 0.0f;
        int n = global_align_c(hf, s, gp, match_u8,
                               (uint32_t)band_radius,
                               (uint32_t)min_global_hsp_length,
                               (float)min_hsp_fract_id,
                               (float)min_hsp_score, (float)xdrop_g,
                               0, 0, paths_buf + cur, &fr);
        if (n <= 0)
            return -10;
        int64_t lr[5];
        uchime_left_right_c(q, t, paths_buf + cur, n, match_u8, 4, lr);
        cur += n;
        path_offs[ti + 1] = cur;
        uint32_t diffs = (uint32_t)lr[0];
        uint32_t pl0 = (uint32_t)lr[1], pl1 = (uint32_t)lr[2];
        uint32_t pr0 = (uint32_t)lr[3], pr1 = (uint32_t)lr[4];
        if (diffs != UMAX && diffs < dqt) {
            top = (uint32_t)ti;
            dqt = diffs;
        }
        if (pl0 != UMAX && pl0 > pbl0) {
            pbl0 = pl0;
            bl0 = (uint32_t)ti;
        }
        if (pr0 != UMAX && pr0 < pbr0) {
            pbr0 = pr0;
            br0 = (uint32_t)ti;
        }
        if (pl1 != UMAX && pl1 > pbl1) {
            pbl1 = pl1;
            bl1 = (uint32_t)ti;
        }
        if (pr1 != UMAX && pr1 < pbr1) {
            pbr1 = pr1;
            br1 = (uint32_t)ti;
        }
        if (dqt == 0) {
            ++ti;
            break;
        }
    }
    state_out[0] = top;
    state_out[1] = dqt;
    state_out[2] = bl0;
    state_out[3] = pbl0;
    state_out[4] = br0;
    state_out[5] = pbr0;
    state_out[6] = bl1;
    state_out[7] = pbl1;
    state_out[8] = br1;
    state_out[9] = pbr1;
    return ti;
}

/* ---- fastq_mergepairs per-pair kernel (src/mergepair.cpp,
 * src/mergealign.cpp:13-172, src/mergepost.cpp) -------------------------
 * Mirrors fastq/merge.py merge_pair(): revcomp the reverse read, HSP
 * seed fwd vs rc-rev (stagger ok), top HSP extended to the full overlap
 * diagonal, gates (minovlen / nostagger / maxdiffs / pctid), posterior
 * quality combination, post length/qual gates.  Status codes:
 *   0 merged, 1 notaligned, 2 ovtooshort, 3 staggered-rejected,
 *   4 maxdiffs, 5 pctid, 6 merged-tooshort, 7 merged-toolong, 8 minq
 * out_meta: status, loi, loj, length, diffs, outlen, stag, unused */
extern uint32_t hsp_ungapped_blast(HSPFinderC *hf, float x, int stagger_ok,
                                   uint32_t min_length, float min_score,
                                   void *out, uint32_t max_out);

typedef struct { uint32_t loi, loj, leni, lenj; float score; } MergeHSP;

int64_t merge_pair_c(
    HSPFinderC *hf, EngineScratch *es,
    const uint8_t *s1, int64_t l1, const uint8_t *q1,
    const uint8_t *s2, int64_t l2, const uint8_t *q2,
    const uint8_t *comp,
    double xdrop, int64_t min_hsp_len, double min_hsp_score,
    int64_t minovlen, int64_t nostagger, int64_t maxdiffs,
    double pctid_min,
    int64_t minmergelen, int64_t maxmergelen, int64_t minqual,
    int64_t base,
    const uint8_t *pm, const uint8_t *pmm,
    uint8_t *out_seq, uint8_t *out_qual, int64_t *out_meta)
{
    /* revcomp(s2) and reverse(q2) into scratch */
    size_t need = (size_t)(l1 + l2 + 2) * 2;
    if (need > es->path_cap) {
        free(es->path);
        es->path_cap = need * 2 + 4096;
        es->path = (char *)malloc(es->path_cap);
    }
    uint8_t *s2rc = (uint8_t *)es->path;
    uint8_t *q2rc = s2rc + l2 + 1;
    for (int64_t i = 0; i < l2; ++i) {
        s2rc[i] = comp[s2[l2 - 1 - i]];
        q2rc[i] = q2[l2 - 1 - i];
    }
    hsp_set_a(hf, s1, (uint32_t)l1);
    hsp_set_b(hf, s2rc, (uint32_t)l2);
    MergeHSP hsps[512];
    uint32_t n = hsp_ungapped_blast(hf, (float)xdrop, 1,
                                    (uint32_t)min_hsp_len,
                                    (float)min_hsp_score, hsps, 512);
    int top = -1;
    for (uint32_t i = 0; i < n; ++i)
        if (top < 0 || hsps[i].score > hsps[top].score)
            top = (int)i;
    if (top < 0) {
        out_meta[0] = 1;
        return 1;
    }
    /* ExtendHSP (src/mergealign.cpp:13-39) */
    uint32_t tloi = hsps[top].loi, tloj = hsps[top].loj;
    int64_t loi = (tloi <= tloj) ? 0 : (int64_t)(tloi - tloj);
    int64_t loj = (tloj <= tloi) ? 0 : (int64_t)(tloj - tloi);
    int64_t len_i = l1 - loi;
    int64_t len_j = l2 - loj;
    int64_t length = len_i < len_j ? len_i : len_j;

    int64_t hii = loi + length - 1;
    int64_t hij = loj + length - 1;
    int64_t left = (loj == 0) ? loi : -loj;
    int64_t right = (hii + 1 == l1) ? (l2 - hij - 1) : -(l2 - hij - 1);
    out_meta[1] = loi;
    out_meta[2] = loj;
    out_meta[3] = length;
    int stag = (left < 0 || right < 0);
    out_meta[6] = stag;
    if (length < minovlen) {
        out_meta[0] = 2;
        return 2;
    }
    if (nostagger && stag) {
        out_meta[0] = 3;
        return 3;
    }
    /* MergeSI (src/mergealign.cpp:44-123) */
    int64_t outn = 0;
    int64_t pos1 = 0, pos2;
    for (; pos1 < loi; ++pos1) {
        out_seq[outn] = s1[pos1];
        out_qual[outn++] = q1[pos1];
    }
    pos2 = loj;
    int64_t diffs = 0;
    for (int64_t k = 0; k < length; ++k) {
        uint8_t c1 = s1[pos1], c2 = s2rc[pos2];
        uint8_t qc1 = q1[pos1], qc2 = q2rc[pos2];
        int64_t iq1 = (int64_t)qc1 - base, iq2 = (int64_t)qc2 - base;
        if (iq1 < 0) iq1 = 0;
        if (iq1 > 63) iq1 = 63;
        if (iq2 < 0) iq2 = 0;
        if (iq2 > 63) iq2 = 63;
        if (c1 == c2) {
            out_seq[outn] = c1;
            out_qual[outn++] = (uint8_t)(pm[64 * iq1 + iq2] + base);
        } else {
            ++diffs;
            out_seq[outn] = (qc1 >= qc2) ? c1 : c2;
            out_qual[outn++] = (uint8_t)(pmm[64 * iq1 + iq2] + base);
        }
        ++pos1;
        ++pos2;
    }
    for (; pos2 < l2; ++pos2) {
        out_seq[outn] = s2rc[pos2];
        out_qual[outn++] = q2rc[pos2];
    }
    out_meta[4] = diffs;
    out_meta[5] = outn;
    if (diffs > maxdiffs) {
        out_meta[0] = 4;
        return 4;
    }
    double pct = length ? 100.0 * (double)(length - diffs) / (double)length
                        : 0.0;
    if (pct < pctid_min) {
        out_meta[0] = 5;
        return 5;
    }
    if (minmergelen > 0 && outn < minmergelen) {
        out_meta[0] = 6;
        return 6;
    }
    if (maxmergelen > 0 && outn > maxmergelen) {
        out_meta[0] = 7;
        return 7;
    }
    if (minqual >= 0) {
        int64_t mq = 1 << 30;
        for (int64_t i = 0; i < outn; ++i) {
            int64_t iq = (int64_t)out_qual[i] - base;
            if (iq < mq)
                mq = iq;
        }
        if (mq < minqual) {
            out_meta[0] = 8;
            return 8;
        }
    }
    out_meta[0] = 0;
    return 0;
}

/* GetEE (src/fastq.cpp): sequential double sum of char->prob. */
double ee_sum_c(const uint8_t *q, int64_t n, const double *char_to_prob)
{
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i)
        s += char_to_prob[q[i]];
    return s;
}

/* ---- fastq_mergepairs whole-file batch loop (src/fastqmerge.cpp,
 * src/mergethread.cpp) ---------------------------------------------------
 * Parses both FASTQ buffers 4-line-record-wise (CRLF tolerated, blank
 * lines skipped before headers), applies MergePre (tail truncation +
 * minlen), merge_pair_c, stats, EE sums, and writes merged records
 * "@label\nseq\n+\nqual\n" into out_buf.  Labels are truncated at the
 * first whitespace (trunclabels).  relabel_prefix != NULL switches to
 * prefix<counter> labels.
 * Returns pairs processed; -3 = out_buf too small (caller grows);
 * -10-i = label mismatch at pair i; -2 = parse error (caller falls back
 * to the Python loop for the exact reference diagnostics).
 * stats_i64[16]: in,out,tail1,tail2,short1,short2,notaligned,ovtooshort,
 *   staggered,exact,maxdiffs,minq,m_tooshort,m_toolong,spare,spare
 * stats_f64[8]: ee1,ee2,ee_merged,sum_ov_len,sum_merged_len */
typedef struct {
    const uint8_t *p;
    int64_t n, pos;
} FqCursor;

static int fq_next_rec(FqCursor *c, const uint8_t **lab, int64_t *lab_n,
                       const uint8_t **seq, int64_t *seq_n,
                       const uint8_t **qual, int64_t *qual_n)
{
    /* skip blank lines */
    while (c->pos < c->n) {
        int64_t e = c->pos;
        while (e < c->n && c->p[e] != '\n')
            ++e;
        int64_t strip = e;
        while (strip > c->pos && c->p[strip - 1] == '\r')
            --strip;
        if (strip > c->pos)
            break;
        c->pos = e + 1;
    }
    if (c->pos >= c->n)
        return 0;
    const uint8_t *lines[4];
    int64_t lens[4];
    for (int k = 0; k < 4; ++k) {
        if (c->pos >= c->n)
            return -1;
        int64_t e = c->pos;
        while (e < c->n && c->p[e] != '\n')
            ++e;
        int64_t strip = e;
        while (strip > c->pos && c->p[strip - 1] == '\r')
            --strip;
        lines[k] = c->p + c->pos;
        lens[k] = strip - c->pos;
        c->pos = e + 1;
    }
    if (lens[0] < 1 || lines[0][0] != '@')
        return -1;
    if (lens[2] < 1 || lines[2][0] != '+')
        return -1;
    if (lens[1] != lens[3])
        return -1;
    *lab = lines[0] + 1;
    *lab_n = lens[0] - 1;
    *seq = lines[1];
    *seq_n = lens[1];
    *qual = lines[3];
    *qual_n = lens[3];
    return 1;
}

static int64_t fq_trunc_label(const uint8_t *lab, int64_t n)
{
    for (int64_t i = 0; i < n; ++i) {
        uint8_t ch = lab[i];
        if (ch == ' ' || ch == '\t' || ch == '\v' || ch == '\f')
            return i;
    }
    return n;
}

static int fq_labels_match(const uint8_t *l1, int64_t n1,
                           const uint8_t *l2, int64_t n2)
{
    if (n1 != n2)
        return 0;
    int found = 0;
    for (int64_t i = 0; i < n1; ++i) {
        if (l1[i] != l2[i]) {
            if (found)
                return 0;
            if (l1[i] != '1' || (l2[i] != '2' && l2[i] != '3'))
                return 0;
            found = 1;
        }
    }
    return 1;
}

static int64_t fq_trunc_tail(const uint8_t *qual, int64_t n,
                             int64_t base, int64_t tt, int64_t max_tail)
{
    int64_t tail = 0;
    for (int64_t k = 0; k < n; ++k) {
        if ((int64_t)qual[n - k - 1] - base <= tt)
            ++tail;
        else
            break;
    }
    if (tail > 0 && tail > max_tail)
        return n - tail;
    return n;
}

extern int64_t merge_pair_c(
    HSPFinderC *hf, EngineScratch *es,
    const uint8_t *s1, int64_t l1, const uint8_t *q1,
    const uint8_t *s2, int64_t l2, const uint8_t *q2,
    const uint8_t *comp,
    double xdrop, int64_t min_hsp_len, double min_hsp_score,
    int64_t minovlen, int64_t nostagger, int64_t maxdiffs,
    double pctid_min,
    int64_t minmergelen, int64_t maxmergelen, int64_t minqual,
    int64_t base,
    const uint8_t *pm, const uint8_t *pmm,
    uint8_t *out_seq, uint8_t *out_qual, int64_t *out_meta);

int64_t merge_files_c(
    HSPFinderC *hf, EngineScratch *es,
    const uint8_t *fwd, int64_t fwd_n,
    const uint8_t *rev, int64_t rev_n,
    const uint8_t *comp, const double *char_to_prob,
    double xdrop, int64_t min_hsp_len, double min_hsp_score,
    int64_t minovlen, int64_t nostagger, int64_t maxdiffs,
    double pctid_min,
    int64_t minmergelen, int64_t maxmergelen, int64_t minqual,
    int64_t base, int64_t trunctail, int64_t max_tail,
    int64_t minlen /* -1 = unfilled */,
    int64_t ignore_label_mismatch,
    const uint8_t *relabel_prefix, int64_t relabel_prefix_n,
    const uint8_t *pm, const uint8_t *pmm,
    uint8_t *out_buf, int64_t out_cap, int64_t *out_len,
    int64_t out_fd,
    int32_t *merge_lengths,
    int64_t *stats_i64, double *stats_f64)
{
    FqCursor c1 = {fwd, fwd_n, 0}, c2 = {rev, rev_n, 0};
    int64_t written = 0;
    uint8_t *mseq = NULL, *mqual = NULL;
    size_t mcap = 0;
    int64_t meta[8];
    int64_t pairs = 0;
    int64_t opos = 0;
    int64_t counter = 0;
    for (;;) {
        const uint8_t *lab1, *s1, *q1, *lab2, *s2, *q2;
        int64_t lab1n, s1n, q1n, lab2n, s2n, q2n;
        int r1 = fq_next_rec(&c1, &lab1, &lab1n, &s1, &s1n, &q1, &q1n);
        if (r1 < 0) {
            free(mseq);
            return -2;
        }
        int r2 = fq_next_rec(&c2, &lab2, &lab2n, &s2, &s2n, &q2, &q2n);
        if (r2 < 0) {
            free(mseq);
            return -2;
        }
        if (r1 == 0 || r2 == 0)
            break;                /* zip(): stop at the shorter file */
        lab1n = fq_trunc_label(lab1, lab1n);
        lab2n = fq_trunc_label(lab2, lab2n);
        if (!ignore_label_mismatch &&
            !fq_labels_match(lab1, lab1n, lab2, lab2n)) {
            free(mseq);
            return -10 - pairs;
        }
        ++stats_i64[0];
        ++pairs;
        /* MergePre */
        int64_t l1t = fq_trunc_tail(q1, q1n, base, trunctail, max_tail);
        if (l1t < s1n)
            ++stats_i64[2];
        if (minlen >= 0 && l1t < minlen) {
            ++stats_i64[4];
            continue;
        }
        int64_t l2t = fq_trunc_tail(q2, q2n, base, trunctail, max_tail);
        if (l2t < s2n)
            ++stats_i64[3];
        if (minlen >= 0 && l2t < minlen) {
            ++stats_i64[5];
            continue;
        }
        if ((size_t)(l1t + l2t + 2) > mcap) {
            free(mseq);
            mcap = (size_t)(l1t + l2t + 2) * 2 + 1024;
            mseq = (uint8_t *)malloc(mcap * 2);
            mqual = mseq + mcap;
        }
        int64_t status = merge_pair_c(
            hf, es, s1, l1t, q1, s2, l2t, q2, comp,
            xdrop, min_hsp_len, min_hsp_score,
            minovlen, nostagger, maxdiffs, pctid_min,
            minmergelen, maxmergelen, minqual, base,
            pm, pmm, mseq, mqual, meta);
        /* stats mirror of _merge_pair_native */
        if (status == 1) {
            ++stats_i64[6];
        } else if (status == 2) {
            ++stats_i64[7];
        } else {
            if (meta[6])
                ++stats_i64[8];
            if (status != 3 && meta[4] == 0)
                ++stats_i64[9];
            if (status == 4 || status == 5)
                ++stats_i64[10];
            else if (status == 6)
                ++stats_i64[12];
            else if (status == 7)
                ++stats_i64[13];
            else if (status == 8)
                ++stats_i64[11];
        }
        if (status != 0)
            continue;
        int64_t outn = meta[5];
        merge_lengths[stats_i64[1]] = (int32_t)outn;
        ++stats_i64[1];
        stats_f64[0] += ee_sum_c(q1, q1n, char_to_prob);
        stats_f64[1] += ee_sum_c(q2, q2n, char_to_prob);
        stats_f64[2] += ee_sum_c(mqual, outn, char_to_prob);
        stats_f64[3] += (double)meta[3];
        stats_f64[4] += (double)outn;
        /* write "@label\nseq\n+\nqual\n" */
        ++counter;
        uint8_t numbuf[24];
        const uint8_t *wl = lab1;
        int64_t wln = lab1n;
        if (relabel_prefix_n > 0) {
            wl = relabel_prefix;
            wln = relabel_prefix_n;
        }
        int64_t need = 1 + wln + 24 + 1 + outn + 3 + outn + 1;
        if (opos + need > out_cap) {
            free(mseq);
            return -3;
        }
        out_buf[opos++] = '@';
        memcpy(out_buf + opos, wl, (size_t)wln);
        opos += wln;
        if (relabel_prefix_n > 0) {
            int64_t nb = 0;
            int64_t v = counter;
            do {
                numbuf[nb++] = (uint8_t)('0' + v % 10);
                v /= 10;
            } while (v);
            while (nb)
                out_buf[opos++] = numbuf[--nb];
        }
        out_buf[opos++] = '\n';
        memcpy(out_buf + opos, mseq, (size_t)outn);
        opos += outn;
        out_buf[opos++] = '\n';
        out_buf[opos++] = '+';
        out_buf[opos++] = '\n';
        memcpy(out_buf + opos, mqual, (size_t)outn);
        opos += outn;
        out_buf[opos++] = '\n';
        /* streaming mode: flush in 4MB chunks so kernel writeback
         * overlaps the merge compute — a single end-of-run write of
         * ~100MB serializes compute + throttled disk I/O and was the
         * whole 0.8x gap vs the (streaming) reference on slow disks */
        if (out_fd >= 0 && opos >= (int64_t)(4 << 20)) {
            int64_t done = 0;
            while (done < opos) {
                int64_t w = (int64_t)write((int)out_fd, out_buf + done,
                                           (size_t)(opos - done));
                if (w < 0) {
                    free(mseq);
                    return -4;
                }
                done += w;
            }
            written += opos;
            opos = 0;
        }
    }
    if (out_fd >= 0 && opos > 0) {
        int64_t done = 0;
        while (done < opos) {
            int64_t w = (int64_t)write((int)out_fd, out_buf + done,
                                       (size_t)(opos - done));
            if (w < 0) {
                free(mseq);
                return -4;
            }
            done += w;
        }
        written += opos;
        opos = 0;
    }
    free(mseq);
    *out_len = out_fd >= 0 ? written : opos;
    return pairs;
}

/* ---- fastq_filter whole-file batch loop (src/fastqfilter.cpp) ---------
 * Per-read trim pipeline in the reference's order (truncqual, trunctail,
 * stripleft, stripright, maxns, minlen, trunclen, minqual, maxee/rate),
 * then formats kept records into fastq/fasta buffers and discarded ones
 * into their buffers.  Unfilled params = -1 (maxee/rate = -1.0).
 * Labels truncate at whitespace when trunc_labels; relabel_prefix
 * switches kept labels to prefix<counter>.
 * Returns reads processed; -2 parse error; -3 an out buffer overflowed
 * (caller grows all and retries). */
int64_t filter_files_c(
    const uint8_t *buf, int64_t buf_n,
    int64_t base,
    int64_t truncqual, int64_t trunctail, int64_t max_tail,
    int64_t stripleft, int64_t stripright, int64_t maxns,
    int64_t minlen, int64_t trunclen, int64_t minqual,
    double maxee, double maxee_rate, const double *char_to_prob,
    int64_t trunc_labels,
    const uint8_t *relabel_prefix, int64_t relabel_prefix_n,
    int64_t fasta_cols,
    uint8_t *out_fq, int64_t cap_fq, int64_t *len_fq,
    uint8_t *out_fa, int64_t cap_fa, int64_t *len_fa,
    uint8_t *out_dfq, int64_t cap_dfq, int64_t *len_dfq,
    uint8_t *out_dfa, int64_t cap_dfa, int64_t *len_dfa)
{
    FqCursor c = {buf, buf_n, 0};
    int64_t reads = 0, counter = 0;
    int64_t pfq = 0, pfa = 0, pdfq = 0, pdfa = 0;
    for (;;) {
        const uint8_t *lab, *seq, *qual;
        int64_t labn, seqn, qualn;
        int r = fq_next_rec(&c, &lab, &labn, &seq, &seqn, &qual, &qualn);
        if (r < 0)
            return -2;
        if (r == 0)
            break;
        ++reads;
        if (trunc_labels)
            labn = fq_trunc_label(lab, labn);
        int64_t lo = 0, n = seqn;   /* current window [lo, lo+n) */
        int good = 1;               /* 1 good, 0 discard */
        if (n == 0)
            good = 0;
        if (good && truncqual >= 0) {
            for (int64_t i = 0; i < n; ++i)
                if ((int64_t)qual[lo + i] - base <= truncqual) {
                    n = i;
                    break;
                }
        }
        if (good && trunctail >= 0) {
            int64_t tail = 0;
            for (int64_t k = 0; k < n; ++k) {
                if ((int64_t)qual[lo + n - k - 1] - base <= trunctail)
                    ++tail;
                else
                    break;
            }
            if (tail > 0 && tail > max_tail)
                n -= tail;
        }
        if (good && stripleft >= 0) {
            if (n <= stripleft)
                good = 0;
            else {
                lo += stripleft;
                n -= stripleft;
            }
        }
        if (good && stripright >= 0) {
            if (n <= stripright)
                good = 0;
            else
                n -= stripright;
        }
        if (good && maxns >= 0) {
            int64_t nc = 0;
            for (int64_t i = 0; i < n; ++i)
                if (seq[lo + i] == 'N' || seq[lo + i] == 'n')
                    ++nc;
            if (nc > maxns)
                good = 0;
        }
        if (good && n == 0)
            good = 0;
        if (good && minlen >= 0 && n < minlen)
            good = 0;
        if (good && trunclen >= 0) {
            if (n < trunclen)
                good = 0;
            else
                n = trunclen;
        }
        if (good && minqual >= 0) {
            int64_t mq = 0;
            if (n > 0) {
                mq = 1 << 30;
                for (int64_t i = 0; i < n; ++i) {
                    int64_t iq = (int64_t)qual[lo + i] - base;
                    if (iq < mq)
                        mq = iq;
                }
            }
            if (mq < minqual)
                good = 0;
        }
        if (good && (maxee >= 0.0 || maxee_rate >= 0.0)) {
            double ee = ee_sum_c(qual + lo, n, char_to_prob);
            if (maxee >= 0.0 && ee > maxee)
                good = 0;
            if (good && maxee_rate >= 0.0 && ee > maxee_rate * (double)n)
                good = 0;
        }
        if (good) {
            ++counter;
            const uint8_t *wl = lab;
            int64_t wln = labn;
            uint8_t numbuf[24];
            int64_t nb = 0;
            if (relabel_prefix_n > 0) {
                wl = relabel_prefix;
                wln = relabel_prefix_n;
                int64_t v = counter;
                do {
                    numbuf[nb++] = (uint8_t)('0' + v % 10);
                    v /= 10;
                } while (v);
            }
            if (out_fq && n > 0) {
                int64_t need = 1 + wln + nb + 1 + n + 3 + n + 1;
                if (pfq + need > cap_fq)
                    return -3;
                out_fq[pfq++] = '@';
                memcpy(out_fq + pfq, wl, (size_t)wln);
                pfq += wln;
                for (int64_t k = nb; k > 0; --k)
                    out_fq[pfq++] = numbuf[k - 1];
                out_fq[pfq++] = '\n';
                memcpy(out_fq + pfq, seq + lo, (size_t)n);
                pfq += n;
                out_fq[pfq++] = '\n';
                out_fq[pfq++] = '+';
                out_fq[pfq++] = '\n';
                memcpy(out_fq + pfq, qual + lo, (size_t)n);
                pfq += n;
                out_fq[pfq++] = '\n';
            }
            if (out_fa && n > 0) {
                int64_t rows = fasta_cols > 0
                    ? (n + fasta_cols - 1) / fasta_cols : 1;
                if (rows == 0)
                    rows = 1;
                int64_t need = 1 + wln + nb + 1 + n + rows + 1;
                if (pfa + need > cap_fa)
                    return -3;
                out_fa[pfa++] = '>';
                memcpy(out_fa + pfa, wl, (size_t)wln);
                pfa += wln;
                for (int64_t k = nb; k > 0; --k)
                    out_fa[pfa++] = numbuf[k - 1];
                out_fa[pfa++] = '\n';
                if (fasta_cols <= 0) {
                    memcpy(out_fa + pfa, seq + lo, (size_t)n);
                    pfa += n;
                    out_fa[pfa++] = '\n';
                } else {
                    for (int64_t i = 0; i < n; i += fasta_cols) {
                        int64_t m = n - i < fasta_cols ? n - i
                                                       : fasta_cols;
                        memcpy(out_fa + pfa, seq + lo + i, (size_t)m);
                        pfa += m;
                        out_fa[pfa++] = '\n';
                    }
                    if (n == 0)
                        out_fa[pfa++] = '\n';
                }
            }
        } else {
            if (n == 0)    /* SeqInfo::ToFastq/ToFasta skip empty seqs */
                continue;
            if (out_dfq) {
                int64_t need = 1 + labn + 1 + n + 3 + n + 1;
                if (pdfq + need > cap_dfq)
                    return -3;
                out_dfq[pdfq++] = '@';
                memcpy(out_dfq + pdfq, lab, (size_t)labn);
                pdfq += labn;
                out_dfq[pdfq++] = '\n';
                memcpy(out_dfq + pdfq, seq + lo, (size_t)n);
                pdfq += n;
                out_dfq[pdfq++] = '\n';
                out_dfq[pdfq++] = '+';
                out_dfq[pdfq++] = '\n';
                memcpy(out_dfq + pdfq, qual + lo, (size_t)n);
                pdfq += n;
                out_dfq[pdfq++] = '\n';
            }
            if (out_dfa) {
                int64_t rows = fasta_cols > 0
                    ? (n + fasta_cols - 1) / fasta_cols : 1;
                if (rows == 0)
                    rows = 1;
                int64_t need = 1 + labn + 1 + n + rows + 1;
                if (pdfa + need > cap_dfa)
                    return -3;
                out_dfa[pdfa++] = '>';
                memcpy(out_dfa + pdfa, lab, (size_t)labn);
                pdfa += labn;
                out_dfa[pdfa++] = '\n';
                if (fasta_cols <= 0) {
                    memcpy(out_dfa + pdfa, seq + lo, (size_t)n);
                    pdfa += n;
                    out_dfa[pdfa++] = '\n';
                } else {
                    for (int64_t i = 0; i < n; i += fasta_cols) {
                        int64_t m = n - i < fasta_cols ? n - i
                                                       : fasta_cols;
                        memcpy(out_dfa + pdfa, seq + lo + i, (size_t)m);
                        pdfa += m;
                        out_dfa[pdfa++] = '\n';
                    }
                    if (n == 0)
                        out_dfa[pdfa++] = '\n';
                }
            }
        }
    }
    *len_fq = pfq;
    *len_fa = pfa;
    *len_dfq = pdfq;
    *len_dfa = pdfa;
    return reads;
}

/* ---- fastx_orient per-read vote (src/orient.cpp:37-135) ---------------
 * Valid fwd words vs reversed valid revcomp words; per-position row-size
 * comparison in float32 (the reference compares float casts), word vote
 * with word_x, counts out.  ctl maps invalid/lowercase to 0xFF.
 * Returns 0; plus/minus counts in out[0..1] (0,0 when the valid-word
 * counts differ). */
int orient_read_c(const uint8_t *seq, int64_t L,
                  const uint8_t *comp, const uint8_t *ctl,
                  int64_t w, int64_t alpha_size,
                  const int64_t *sizes,
                  double word_x, int64_t *out)
{
    out[0] = out[1] = 0;
    if (L < w)
        return 0;
    int64_t n = L - w + 1;
    int64_t *wf = (int64_t *)malloc((size_t)n * 2 * sizeof(int64_t));
    int64_t *wr = wf + n;
    int64_t nf = 0, nr = 0;
    int64_t pw = 1;
    for (int64_t k = 1; k < w; ++k)
        pw *= alpha_size;
    /* forward */
    int64_t word = 0, run = 0;
    for (int64_t i = 0; i < L; ++i) {
        uint8_t let = ctl[seq[i]];
        if (let == 0xFF) {
            run = 0;
            word = 0;
            continue;
        }
        if (run >= w)
            word = (pw & (pw - 1)) == 0 ? (word & (pw - 1))
                                        : word - (word / pw) * pw;
        word = word * alpha_size + let;
        if (++run >= w)
            wf[nf++] = word;
    }
    /* revcomp */
    word = 0;
    run = 0;
    for (int64_t i = 0; i < L; ++i) {
        uint8_t let = ctl[comp[seq[L - 1 - i]]];
        if (let == 0xFF) {
            run = 0;
            word = 0;
            continue;
        }
        if (run >= w)
            word = (pw & (pw - 1)) == 0 ? (word & (pw - 1))
                                        : word - (word / pw) * pw;
        word = word * alpha_size + let;
        if (++run >= w)
            wr[nr++] = word;
    }
    if (nf != nr || nf == 0) {
        free(wf);
        return 0;
    }
    int64_t plus = 0, minus = 0;
    float wx = (float)word_x;
    for (int64_t i = 0; i < nf; ++i) {
        float s1 = (float)sizes[wf[i]];
        float s2 = (float)sizes[wr[nf - 1 - i]];
        if (s1 > s2 * wx)
            ++plus;
        if (s2 > s1 * wx)
            ++minus;
    }
    out[0] = plus;
    out[1] = minus;
    free(wf);
    return 0;
}

/* fastx_uniques fasta emission: selected uniques in sorted order.
 * plen >= 0: generated labels "<prefix><1-based counter>" (+
 * ";size=N;" when with_size); plen < 0: original label bytes from
 * (lblbuf, lo, le) passed through unmodified (with_size must be 0 —
 * strip_size rewriting stays in Python).  Returns bytes written or -1
 * on overflow. */
int64_t uniques_fasta_emit_c(
    const uint8_t *seqbuf, const int64_t *soff,
    const int64_t *sel, int64_t n_sel,
    const uint8_t *prefix, int64_t plen,
    const uint8_t *lblbuf, const int64_t *lo, const int64_t *le,
    const int64_t *sizes, int32_t with_size,
    int64_t cols, char *out, int64_t cap)
{
    int64_t pos = 0;
    for (int64_t k = 0; k < n_sel; ++k) {
        int64_t si = sel[k];
        int64_t L = soff[si + 1] - soff[si];
        int64_t rows = cols > 0 ? (L + cols - 1) / cols : 1;
        int64_t lmax = plen >= 0 ? plen + 64 : (le[si] - lo[si]) + 64;
        if (pos + lmax + L + rows + 8 > cap)
            return -1;
        out[pos++] = '>';
        if (plen >= 0) {
            memcpy(out + pos, prefix, (size_t)plen);
            pos += plen;
            pos += sprintf(out + pos, "%lld", (long long)(k + 1));
            if (with_size)
                pos += sprintf(out + pos, ";size=%lld;",
                               (long long)sizes[k]);
        } else {
            int64_t ln = le[si] - lo[si];
            memcpy(out + pos, lblbuf + lo[si], (size_t)ln);
            pos += ln;
        }
        out[pos++] = '\n';
        const uint8_t *sq = seqbuf + soff[si];
        if (cols <= 0) {
            memcpy(out + pos, sq, (size_t)L);
            pos += L;
            out[pos++] = '\n';
        } else {
            for (int64_t c0 = 0; c0 < L; c0 += cols) {
                int64_t c1 = c0 + cols < L ? c0 + cols : L;
                memcpy(out + pos, sq + c0, (size_t)(c1 - c0));
                pos += c1 - c0;
                out[pos++] = '\n';
            }
            if (L == 0)
                out[pos++] = '\n';
        }
    }
    return pos;
}

/* whole-file orient: per-read strand vote + fasta emission ---------- */

void orient_batch_c(const uint8_t *seqbuf, const int64_t *soff,
                    int64_t n, const uint8_t *comp, const uint8_t *ctl,
                    int64_t w, int64_t alpha_size, const int64_t *sizes,
                    double word_x, int64_t *out_plus, int64_t *out_minus)
{
    int64_t out2[2];
    for (int64_t r = 0; r < n; ++r) {
        int64_t L = soff[r + 1] - soff[r];
        out2[0] = out2[1] = 0;
        if (L >= w)
            orient_read_c(seqbuf + soff[r], L, comp, ctl, w, alpha_size,
                          sizes, word_x, out2);
        out_plus[r] = out2[0];
        out_minus[r] = out2[1];
    }
}

/* decision[r]: +1 plus, -1 minus (revcomp on emit), 0 undecided.
 * mode 0 emits decided reads (fastaout), mode 1 emits undecided
 * (notmatched).  Returns bytes written or -1 on overflow. */
int64_t orient_fasta_emit_c(const uint8_t *seqbuf, const int64_t *soff,
                            const uint8_t *lblbuf, const int64_t *lo,
                            const int64_t *le, int64_t n,
                            const uint8_t *comp, const int8_t *decision,
                            int32_t mode, int64_t cols,
                            char *out, int64_t cap)
{
    int64_t pos = 0;
    for (int64_t r = 0; r < n; ++r) {
        int8_t d = decision[r];
        if (mode == 0 ? (d == 0) : (d != 0))
            continue;
        int64_t L = soff[r + 1] - soff[r];
        int64_t ln = le[r] - lo[r];
        int64_t rows = cols > 0 ? (L + cols - 1) / cols : 1;
        if (pos + ln + L + rows + 8 > cap)
            return -1;
        out[pos++] = '>';
        memcpy(out + pos, lblbuf + lo[r], (size_t)ln);
        pos += ln;
        out[pos++] = '\n';
        const uint8_t *sq = seqbuf + soff[r];
        if (cols <= 0) {
            if (d == -1)
                for (int64_t i = 0; i < L; ++i)
                    out[pos++] = (char)comp[sq[L - 1 - i]];
            else
                { memcpy(out + pos, sq, (size_t)L); pos += L; }
            out[pos++] = '\n';
        } else {
            for (int64_t c0 = 0; c0 < L; c0 += cols) {
                int64_t c1 = c0 + cols < L ? c0 + cols : L;
                if (d == -1)
                    for (int64_t i = c0; i < c1; ++i)
                        out[pos++] = (char)comp[sq[L - 1 - i]];
                else
                    { memcpy(out + pos, sq + c0, (size_t)(c1 - c0));
                      pos += c1 - c0; }
                out[pos++] = '\n';
            }
            if (L == 0)
                out[pos++] = '\n';
        }
    }
    return pos;
}

/* ---- UPARSE segmenting DP (src/uparsedp.cpp:14-178) -------------------
 * Column DP over the star MSA: dp[j][col+1] = max(dp[j][col],
 * best-other + break) + column score, float32 exactly like the
 * reference's Mx<float>; first-wins argmax scans.  Outputs the
 * per-column winning candidate (traceback) and per-candidate whole-row
 * diff counts.  msa is (n_cand+1) x cols row-major; last row = query. */
int uparse_dp_c(const uint8_t *msa, int64_t n_cand, int64_t cols,
                const uint8_t *to_upper, const uint8_t *match_mx,
                double match_score, double mismatch_score,
                double break_score,
                int64_t *col_to_cand, int64_t *diffs_out,
                int64_t *top_out)
{
    const uint8_t *qrow = msa + (size_t)n_cand * cols;
    const uint8_t DOT = '.';
    for (int64_t j = 0; j < n_cand; ++j) {
        const uint8_t *row = msa + (size_t)j * cols;
        int64_t d = 0;
        for (int64_t c = 0; c < cols; ++c)
            if (!match_mx[256 * (size_t)qrow[c] + row[c]])
                ++d;
        diffs_out[j] = d;
    }
    int64_t top = 0;
    for (int64_t j = 1; j < n_cand; ++j)
        if (diffs_out[j] < diffs_out[top])
            top = j;
    *top_out = top;

    float ms = (float)match_score, xs = (float)mismatch_score,
          bs = (float)break_score;
    float *dp = (float *)malloc((size_t)n_cand * 2 * sizeof(float));
    float *cur = dp, *nxt = dp + n_cand;
    int64_t *tb = (int64_t *)malloc((size_t)n_cand * (cols + 1) *
                                    sizeof(int64_t));
    for (int64_t j = 0; j < n_cand; ++j) {
        cur[j] = 0.0f;
        tb[j] = j;
    }
    for (int64_t col = 0; col < cols; ++col) {
        uint8_t q = qrow[col];
        uint8_t qu = to_upper[q];
        /* first-wins top-2 of cur[i] + break */
        int64_t i1 = 0;
        float m1 = cur[0] + bs;
        for (int64_t i = 1; i < n_cand; ++i) {
            float v = cur[i] + bs;
            if (v > m1) {
                m1 = v;
                i1 = i;
            }
        }
        int64_t i2 = i1;
        float m2 = -1e30f;
        int got2 = 0;
        for (int64_t i = 0; i < n_cand; ++i) {
            if (i == i1)
                continue;
            float v = cur[i] + bs;
            if (!got2 || v > m2) {
                m2 = v;
                i2 = i;
                got2 = 1;
            }
        }
        int64_t *tbc = tb + (size_t)(col + 1) * n_cand;
        for (int64_t j = 0; j < n_cand; ++j) {
            float sw = (j == i1) ? m2 : m1;
            int64_t si = (j == i1) ? i2 : i1;
            float best = cur[j];
            int64_t bj = j;
            if ((j == i1 && !got2 ? 0 : 1) && sw > best) {
                best = sw;
                bj = si;
            }
            uint8_t t = msa[(size_t)j * cols + col];
            float sc;
            if (to_upper[t] == qu)
                sc = ms;
            else if (q == DOT || t == DOT)
                sc = 0.0f;
            else
                sc = xs;
            nxt[j] = best + sc;
            tbc[j] = bj;
        }
        float *tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    int64_t j = 0;
    for (int64_t i = 1; i < n_cand; ++i)
        if (cur[i] > cur[j])
            j = i;
    for (int64_t k = cols; k > 0; --k) {
        col_to_cand[k - 1] = j;
        j = tb[(size_t)k * n_cand + j];
    }
    free(dp);
    free(tb);
    return 0;
}

/* ---- fastq_join whole-file loop (src/fastqjoin.cpp) -------------------
 * Concatenate fwd + pad + revcomp(rev) with reversed quals + padq.
 * relabel: mode 0 keep, 1 prefix<counter>, 2 label+suffix<counter>.
 * Returns pairs; -2 parse error, -3 buffer overflow, -10-i label
 * mismatch at pair i (caller reruns the Python loop for diagnostics). */
int64_t join_files_c(
    const uint8_t *fwd, int64_t fwd_n,
    const uint8_t *rev, int64_t rev_n,
    const uint8_t *comp,
    const uint8_t *pad, int64_t pad_n,
    const uint8_t *padq, int64_t padq_n,
    int64_t stripleft, int64_t stripright,   /* -1 = unfilled */
    int64_t trunc_labels, int64_t ignore_label_mismatch,
    int64_t relabel_mode, const uint8_t *relabel, int64_t relabel_n,
    int64_t fasta_cols,
    uint8_t *out_fq, int64_t cap_fq, int64_t *len_fq,
    uint8_t *out_fa, int64_t cap_fa, int64_t *len_fa)
{
    FqCursor c1 = {fwd, fwd_n, 0}, c2 = {rev, rev_n, 0};
    int64_t pairs = 0, count = 0, pfq = 0, pfa = 0;
    for (;;) {
        const uint8_t *lab1, *s1, *q1, *lab2, *s2, *q2;
        int64_t lab1n, s1n, q1n, lab2n, s2n, q2n;
        int r1 = fq_next_rec(&c1, &lab1, &lab1n, &s1, &s1n, &q1, &q1n);
        int r2 = fq_next_rec(&c2, &lab2, &lab2n, &s2, &s2n, &q2, &q2n);
        if (r1 < 0 || r2 < 0)
            return -2;
        if (r1 == 0 || r2 == 0)
            break;
        if (trunc_labels) {
            lab1n = fq_trunc_label(lab1, lab1n);
            lab2n = fq_trunc_label(lab2, lab2n);
        }
        if (!ignore_label_mismatch &&
            !fq_labels_match(lab1, lab1n, lab2, lab2n))
            return -10 - pairs;
        ++pairs;
        int64_t lo1 = 0, n1 = s1n;
        if (stripleft >= 0) {
            lo1 = stripleft < s1n ? stripleft : s1n;
            n1 = s1n - lo1;
        }
        int64_t n2 = s2n;
        if (stripright >= 0)
            n2 = stripright < s2n ? s2n - stripright : 0;
        /* label */
        uint8_t labbuf[512];
        int64_t labn = 0;
        if (relabel_mode == 0) {
            if (lab1n > 480)
                return -2;
            memcpy(labbuf, lab1, (size_t)lab1n);
            labn = lab1n;
        } else {
            ++count;
            if (relabel_mode == 2) {
                if (lab1n + relabel_n > 460)
                    return -2;
                memcpy(labbuf, lab1, (size_t)lab1n);
                labn = lab1n;
            } else if (relabel_n > 460) {
                return -2;
            }
            memcpy(labbuf + labn, relabel, (size_t)relabel_n);
            labn += relabel_n;
            uint8_t nb[24];
            int64_t k = 0, v = count;
            do {
                nb[k++] = (uint8_t)('0' + v % 10);
                v /= 10;
            } while (v);
            while (k)
                labbuf[labn++] = nb[--k];
        }
        int64_t jn = n1 + pad_n + n2;
        if (out_fq) {
            int64_t need = 1 + labn + 1 + jn + 3 + jn + 1;
            if (pfq + need > cap_fq)
                return -3;
            out_fq[pfq++] = '@';
            memcpy(out_fq + pfq, labbuf, (size_t)labn);
            pfq += labn;
            out_fq[pfq++] = '\n';
            memcpy(out_fq + pfq, s1 + lo1, (size_t)n1);
            pfq += n1;
            memcpy(out_fq + pfq, pad, (size_t)pad_n);
            pfq += pad_n;
            for (int64_t i = 0; i < n2; ++i)
                out_fq[pfq + i] = comp[s2[s2n - 1 - i]];
            pfq += n2;
            out_fq[pfq++] = '\n';
            out_fq[pfq++] = '+';
            out_fq[pfq++] = '\n';
            memcpy(out_fq + pfq, q1 + lo1, (size_t)n1);
            pfq += n1;
            memcpy(out_fq + pfq, padq, (size_t)padq_n);
            pfq += padq_n;
            for (int64_t i = 0; i < n2; ++i)
                out_fq[pfq + i] = q2[s2n - 1 - i];
            pfq += n2;
            out_fq[pfq++] = '\n';
        }
        if (out_fa) {
            int64_t rows = fasta_cols > 0
                ? (jn + fasta_cols - 1) / fasta_cols : 1;
            if (rows == 0)
                rows = 1;
            int64_t need = 1 + labn + 1 + jn + rows + 1;
            if (pfa + need > cap_fa)
                return -3;
            out_fa[pfa++] = '>';
            memcpy(out_fa + pfa, labbuf, (size_t)labn);
            pfa += labn;
            out_fa[pfa++] = '\n';
            /* build joined seq inline then wrap */
            /* write wrapped directly */
            int64_t written = 0;
            int64_t line = 0;
            for (int64_t i = 0; i < jn; ++i) {
                uint8_t ch;
                if (i < n1)
                    ch = s1[lo1 + i];
                else if (i < n1 + pad_n)
                    ch = pad[i - n1];
                else
                    ch = comp[s2[s2n - 1 - (i - n1 - pad_n)]];
                out_fa[pfa++] = ch;
                ++written;
                ++line;
                if (fasta_cols > 0 && line == fasta_cols) {
                    out_fa[pfa++] = '\n';
                    line = 0;
                }
            }
            if (fasta_cols <= 0 || line != 0 || jn == 0)
                out_fa[pfa++] = '\n';
        }
    }
    *len_fq = pfq;
    *len_fa = pfa;
    return pairs;
}

/* ---- full-length dereplication (src/derepfull.cpp) --------------------
 * Open-addressing hash over uppercased sequences; cluster ids assigned
 * in first-occurrence order (the reference's single-thread semantics).
 * Returns the number of uniques; out_cluster[i] = cluster id of seq i. */
int64_t derep_c(const uint8_t *cat, const int64_t *offs, int64_t n,
                const uint8_t *to_upper, int32_t *out_cluster)
{
    if (n == 0)
        return 0;
    int64_t total = offs[n];
    uint8_t *up = (uint8_t *)malloc((size_t)total);
    for (int64_t i = 0; i < total; ++i)
        up[i] = to_upper[cat[i]];
    uint64_t slots = 16;
    while (slots < (uint64_t)n * 2)
        slots <<= 1;
    int64_t *table = (int64_t *)malloc(slots * sizeof(int64_t));
    for (uint64_t i = 0; i < slots; ++i)
        table[i] = -1;
    uint64_t *hashes = (uint64_t *)malloc((size_t)n * sizeof(uint64_t));
    int64_t nu = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t *s = up + offs[i];
        int64_t L = offs[i + 1] - offs[i];
        uint64_t h = 1469598103934665603ull;      /* FNV-1a */
        for (int64_t k = 0; k < L; ++k) {
            h ^= s[k];
            h *= 1099511628211ull;
        }
        hashes[i] = h;
        uint64_t slot = h & (slots - 1);
        int32_t cl = -1;
        for (;;) {
            int64_t j = table[slot];
            if (j < 0) {
                table[slot] = i;
                cl = (int32_t)nu++;
                break;
            }
            int64_t Lj = offs[j + 1] - offs[j];
            if (hashes[j] == h && Lj == L &&
                memcmp(up + offs[j], s, (size_t)L) == 0) {
                cl = out_cluster[j];
                break;
            }
            slot = (slot + 1) & (slots - 1);
        }
        out_cluster[i] = cl;
    }
    free(up);
    free(table);
    free(hashes);
    return nu;
}

/* ---- UNOISE3 greedy denoise loop (src/unoise3.cpp:62-233) -------------
 * Per size-sorted unique read: GetHot top-8 centroids by shared unique
 * words (max drop 8), HSP-anchored global align to each
 * (fail_if_no_hsps), absorb when mismatch diffs d satisfy
 * skew = tsize/qsize >= 2^(alpha*d + 1); miss admits a new centroid
 * into the ClusterCtx 3-tier index.  out_ti[q] = centroid index or -1
 * (admitted, becoming centroid #out_ti via admission order);
 * out_diffs[q] = best diffs (or -1). */
int64_t unoise_greedy_c(
    ClusterCtx *cc, HSPFinderC *hf, AlignScratch *as, EngineScratch *es,
    const GapParams *gp, const byte *match_mx,
    uint32_t band_radius, uint32_t min_hsp_len, float min_hsp_fract,
    float min_hsp_score, float xdrop_g,
    const uint8_t *ctl_rank, uint32_t alpha_size, uint32_t wlen,
    int64_t slot_count, uint32_t bump_pct,
    double alpha, int32_t max_accepts,
    const uint8_t *qbuf, const int64_t *q_off, int64_t n_queries,
    const int64_t *qsizes,
    int32_t *out_ti, int32_t *out_diffs)
{
    const int MAX_HOT_C = 8, MAX_DROP_C = 8;
    cc_index_init(cc, slot_count);
    int64_t *cent_size = (int64_t *)malloc(
        (size_t)n_queries * sizeof(int64_t));
    int64_t n_cent = 0;
    for (int64_t q = 0; q < n_queries; ++q) {
        const uint8_t *seq = qbuf + q_off[q];
        int64_t L = q_off[q + 1] - q_off[q];
        uint32_t nuw = 0;
        uint32_t n_cand = cc_rank(cc, seq, L, ctl_rank, alpha_size,
                                  wlen, slot_count, (uint32_t)cc->db_n,
                                  bump_pct, MAX_HOT_C, &nuw);
        int32_t best_t = -1, best_diffs = -1;
        if (n_cand) {
            hsp_set_a(hf, seq, (uint32_t)L);
            uint32_t top_count = cc->cand_cnt[0];
            int32_t accept_count = 0;
            uint32_t nh = n_cand < (uint32_t)MAX_HOT_C ? n_cand
                                                       : MAX_HOT_C;
            for (uint32_t i = 0; i < nh; ++i) {
                if (i > 0 &&
                    top_count - cc->cand_cnt[i] > (uint32_t)MAX_DROP_C)
                    break;
                int32_t ti = (int32_t)cc->cand_tix[i];
                const uint8_t *t = cc->db + cc->db_off[ti];
                int64_t tl = cc->db_off[ti + 1] - cc->db_off[ti];
                hsp_set_b(hf, t, (uint32_t)tl);
                if ((size_t)(L + tl + 2) > es->path_cap) {
                    free(es->path);
                    es->path_cap = (size_t)(L + tl + 2) * 2 + 4096;
                    es->path = (char *)malloc(es->path_cap);
                }
                float fr = 0.0f;
                int n = global_align_c(hf, as, gp, match_mx, band_radius,
                                       min_hsp_len, min_hsp_fract,
                                       min_hsp_score, xdrop_g, 0, 1,
                                       es->path, &fr);
                if (n > 0) {
                    /* mismatch diffs over M columns */
                    int64_t qi = 0, tj = 0, diffs = 0;
                    for (int k = 0; k < n; ++k) {
                        char c = es->path[k];
                        if (c == 'M') {
                            if (!match_mx[256 * (size_t)seq[qi] + t[tj]])
                                ++diffs;
                            ++qi;
                            ++tj;
                        } else if (c == 'D') {
                            ++qi;
                        } else {
                            ++tj;
                        }
                    }
                    int accept;
                    if (diffs == 0) {
                        accept = 1;
                    } else {
                        double skew = (double)cent_size[ti]
                            / (double)qsizes[q];
                        double min_skew =
                            pow(2.0, (double)diffs * alpha + 1.0);
                        accept = skew >= min_skew;
                    }
                    if (accept) {
                        ++accept_count;
                        if (best_diffs < 0 || diffs < best_diffs) {
                            best_t = ti;
                            best_diffs = (int32_t)diffs;
                        }
                    }
                }
                if (best_diffs >= 0 && best_diffs <= 1)
                    break;
                if (accept_count >= max_accepts)
                    break;
            }
        }
        out_ti[q] = best_t;
        out_diffs[q] = best_diffs;
        if (best_t < 0) {
            /* admit as centroid (same delta-tier indexing as
             * cluster_greedy_c's admission) */
            int64_t ci = cc->db_n;
            cent_size[ci] = qsizes[q];
            ++n_cent;
            if (cc->db_n + 1 >= cc->db_n_cap) {
                cc->db_n_cap *= 2;
                cc->db_off = (int64_t *)realloc(
                    cc->db_off, (cc->db_n_cap + 1) * sizeof(int64_t));
            }
            if (cc->db_bytes + L > cc->db_bytes_cap) {
                while (cc->db_bytes + L > cc->db_bytes_cap)
                    cc->db_bytes_cap *= 2;
                cc->db = (uint8_t *)realloc(cc->db, cc->db_bytes_cap);
            }
            memcpy(cc->db + cc->db_bytes, seq, (size_t)L);
            cc->db_off[ci] = cc->db_bytes;
            cc->db_bytes += L;
            cc->db_off[ci + 1] = cc->db_bytes;
            cc->db_n = ci + 1;
            cc_alloc_rank(cc, (uint32_t)cc->db_n, slot_count,
                          (uint32_t)L);
            int64_t pow_w = 1;
            for (uint32_t k = 1; k < wlen; ++k)
                pow_w *= alpha_size;
            uint32_t nw = 0;
            int64_t word = 0;
            uint32_t run = 0;
            for (int64_t i = 0; i < L; ++i) {
                uint8_t let = ctl_rank[seq[i]];
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
                    if (!(cc->seen[word >> 3] & (1u << (word & 7)))) {
                        cc->seen[word >> 3] |=
                            (uint8_t)(1u << (word & 7));
                        cc->uw[nw++] = word;
                    }
                }
            }
            for (uint32_t k = 0; k < nw; ++k)
                cc->seen[cc->uw[k] >> 3] = 0;
            if (cc->dn + nw > cc->dcap) {
                while (cc->dn + nw > cc->dcap)
                    cc->dcap *= 2;
                cc->dw = (int64_t *)realloc(
                    cc->dw, cc->dcap * sizeof(int64_t));
                cc->dt = (int32_t *)realloc(
                    cc->dt, cc->dcap * sizeof(int32_t));
            }
            for (uint32_t k = 0; k < nw; ++k) {
                cc->dw[cc->dn] = cc->uw[k];
                cc->dt[cc->dn] = (int32_t)ci;
                ++cc->dn;
            }
            if (cc->dn >= CC_RAW_LIMIT)
                cc_flush_raw(cc);
        }
    }
    free(cent_size);
    return n_cent;
}

/* ---- fastx_truncate whole-file loop (src/fastxtruncate.cpp) -----------
 * stripleft/stripright (skip when too short), pad to padlen with
 * 'N'/padq, trunclen (skip when shorter), min/maxseqlength gates,
 * relabel modes as join_files_c.  FASTQ input only (FASTA falls back).
 * Returns reads; -2 parse error; -3 buffer overflow. */
int64_t truncate_files_c(
    const uint8_t *buf, int64_t buf_n,
    int64_t stripleft, int64_t stripright,
    int64_t padlen, uint8_t padq,
    int64_t trunclen, int64_t minlen, int64_t maxlen,
    int64_t trunc_labels,
    int64_t relabel_mode, const uint8_t *relabel, int64_t relabel_n,
    int64_t fasta_cols,
    uint8_t *out_fq, int64_t cap_fq, int64_t *len_fq,
    uint8_t *out_fa, int64_t cap_fa, int64_t *len_fa)
{
    FqCursor c = {buf, buf_n, 0};
    int64_t reads = 0, n_out = 0, pfq = 0, pfa = 0;
    uint8_t *tmp = NULL;
    size_t tmp_cap = 0;
    for (;;) {
        const uint8_t *lab, *seq, *qual;
        int64_t labn, seqn, qualn;
        int r = fq_next_rec(&c, &lab, &labn, &seq, &seqn, &qual, &qualn);
        if (r < 0) {
            free(tmp);
            return -2;
        }
        if (r == 0)
            break;
        ++reads;
        if (trunc_labels)
            labn = fq_trunc_label(lab, labn);
        int64_t lo = 0, n = seqn;
        if (seqn <= stripleft)
            continue;
        lo += stripleft;
        n -= stripleft;
        if (n <= stripright)
            continue;
        n -= stripright;
        const uint8_t *s = seq + lo, *q = qual + lo;
        if (n < padlen) {
            if ((size_t)padlen * 2 > tmp_cap) {
                free(tmp);
                tmp_cap = (size_t)padlen * 4 + 256;
                tmp = (uint8_t *)malloc(tmp_cap);
            }
            memcpy(tmp, s, (size_t)n);
            memset(tmp + n, 'N', (size_t)(padlen - n));
            memcpy(tmp + padlen, q, (size_t)n);
            memset(tmp + padlen + n, padq, (size_t)(padlen - n));
            s = tmp;
            q = tmp + padlen;
            n = padlen;
        }
        if (n < trunclen)
            continue;
        n = trunclen;
        if (minlen >= 0 && n < minlen)
            continue;
        if (maxlen >= 0 && n > maxlen)
            continue;
        ++n_out;
        uint8_t labbuf[560];
        int64_t wn = 0;
        if (relabel_mode == 0) {
            if (labn > 540) {
                free(tmp);
                return -2;
            }
            memcpy(labbuf, lab, (size_t)labn);
            wn = labn;
        } else {
            if (labn + relabel_n > 500) {
                free(tmp);
                return -2;
            }
            if (relabel_mode == 2 || relabel_mode == 3) {
                memcpy(labbuf, lab, (size_t)labn);
                wn = labn;
            }
            memcpy(labbuf + wn, relabel, (size_t)relabel_n);
            wn += relabel_n;
            if (relabel_mode != 3) {   /* 3 = plain suffix, no counter */
                uint8_t nb[24];
                int64_t k = 0, v = n_out;
                do {
                    nb[k++] = (uint8_t)('0' + v % 10);
                    v /= 10;
                } while (v);
                while (k)
                    labbuf[wn++] = nb[--k];
            }
        }
        if (out_fq) {
            int64_t need = 1 + wn + 1 + n + 3 + n + 1;
            if (pfq + need > cap_fq) {
                free(tmp);
                return -3;
            }
            out_fq[pfq++] = '@';
            memcpy(out_fq + pfq, labbuf, (size_t)wn);
            pfq += wn;
            out_fq[pfq++] = '\n';
            memcpy(out_fq + pfq, s, (size_t)n);
            pfq += n;
            out_fq[pfq++] = '\n';
            out_fq[pfq++] = '+';
            out_fq[pfq++] = '\n';
            memcpy(out_fq + pfq, q, (size_t)n);
            pfq += n;
            out_fq[pfq++] = '\n';
        }
        if (out_fa) {
            int64_t rows = fasta_cols > 0
                ? (n + fasta_cols - 1) / fasta_cols : 1;
            if (rows == 0)
                rows = 1;
            int64_t need = 1 + wn + 1 + n + rows + 1;
            if (pfa + need > cap_fa) {
                free(tmp);
                return -3;
            }
            out_fa[pfa++] = '>';
            memcpy(out_fa + pfa, labbuf, (size_t)wn);
            pfa += wn;
            out_fa[pfa++] = '\n';
            if (fasta_cols <= 0) {
                memcpy(out_fa + pfa, s, (size_t)n);
                pfa += n;
                out_fa[pfa++] = '\n';
            } else {
                for (int64_t i = 0; i < n; i += fasta_cols) {
                    int64_t m = n - i < fasta_cols ? n - i : fasta_cols;
                    memcpy(out_fa + pfa, s + i, (size_t)m);
                    pfa += m;
                    out_fa[pfa++] = '\n';
                }
                if (n == 0)
                    out_fa[pfa++] = '\n';
            }
        }
    }
    free(tmp);
    *len_fq = pfq;
    *len_fa = pfa;
    return reads;
}

/* ---- fastq_filter2 whole-file loop (src/fastqfilter2.cpp) -------------
 * Keep pairs where both reads have EE <= max_ee and zero N/n bases;
 * records are echoed verbatim (label untouched).  Returns pairs,
 * -2 parse error, -3 overflow. */
int64_t filter2_files_c(
    const uint8_t *fwd, int64_t fwd_n,
    const uint8_t *rev, int64_t rev_n,
    double max_ee, const double *char_to_prob,
    uint8_t *out1, int64_t cap1, int64_t *len1,
    uint8_t *out2, int64_t cap2, int64_t *len2)
{
    FqCursor c1 = {fwd, fwd_n, 0}, c2 = {rev, rev_n, 0};
    int64_t pairs = 0, p1 = 0, p2 = 0;
    for (;;) {
        const uint8_t *lab1, *s1, *q1, *lab2, *s2, *q2;
        int64_t lab1n, s1n, q1n, lab2n, s2n, q2n;
        int r1 = fq_next_rec(&c1, &lab1, &lab1n, &s1, &s1n, &q1, &q1n);
        int r2 = fq_next_rec(&c2, &lab2, &lab2n, &s2, &s2n, &q2, &q2n);
        if (r1 < 0 || r2 < 0)
            return -2;
        if (r1 == 0 || r2 == 0)
            break;
        ++pairs;
        int ok = 1;
        for (int64_t i = 0; i < s1n && ok; ++i)
            if (s1[i] == 'N' || s1[i] == 'n')
                ok = 0;
        for (int64_t i = 0; i < s2n && ok; ++i)
            if (s2[i] == 'N' || s2[i] == 'n')
                ok = 0;
        if (ok && (ee_sum_c(q1, q1n, char_to_prob) > max_ee ||
                   ee_sum_c(q2, q2n, char_to_prob) > max_ee))
            ok = 0;
        if (!ok)
            continue;
        if (out1 && s1n > 0) {     /* ToFastq skips empty seqs */
            int64_t need = 1 + lab1n + 1 + s1n + 3 + q1n + 1;
            if (p1 + need > cap1)
                return -3;
            out1[p1++] = '@';
            memcpy(out1 + p1, lab1, (size_t)lab1n);
            p1 += lab1n;
            out1[p1++] = '\n';
            memcpy(out1 + p1, s1, (size_t)s1n);
            p1 += s1n;
            out1[p1++] = '\n';
            out1[p1++] = '+';
            out1[p1++] = '\n';
            memcpy(out1 + p1, q1, (size_t)q1n);
            p1 += q1n;
            out1[p1++] = '\n';
        }
        if (out2 && s2n > 0) {
            int64_t need = 1 + lab2n + 1 + s2n + 3 + q2n + 1;
            if (p2 + need > cap2)
                return -3;
            out2[p2++] = '@';
            memcpy(out2 + p2, lab2, (size_t)lab2n);
            p2 += lab2n;
            out2[p2++] = '\n';
            memcpy(out2 + p2, s2, (size_t)s2n);
            p2 += s2n;
            out2[p2++] = '\n';
            out2[p2++] = '+';
            out2[p2++] = '\n';
            memcpy(out2 + p2, q2, (size_t)q2n);
            p2 += q2n;
            out2[p2++] = '\n';
        }
    }
    *len1 = p1;
    *len2 = p2;
    return pairs;
}

/* ---- sintax whole-window classify core (src/sintaxsearcher.cpp) -------
 * For each query: forward (and optional revcomp) strand unique words ->
 * sintax_boots_c -> winner-tax tallies; strand with the higher top word
 * count wins (fwd on ties); the reference's m_TopWordCount quirk means
 * the '*'-row check uses the LAST classified strand's count.  Writes the
 * chosen strand's ordered (tax id, count) list per query.
 * out_strand: '+', '-', or 0 when nuw < 8 on every strand. */
int64_t sintax_window_c(
    EngineScratch *es,
    const uint8_t *qcat, const int64_t *q_off, int64_t n_q,
    const uint8_t *comp, int strand_both,
    const uint8_t *ctl, uint32_t alpha_size, uint32_t wlen,
    int64_t slot_count,
    const int64_t *starts, const int32_t *postings, uint32_t seq_count,
    int boots, int boot_subset, int subset_divide,
    uint32_t r0, uint64_t *grand_x,
    const int32_t *tax_id,
    int32_t *out_ntax, int32_t *out_ids, int32_t *out_cnts,
    int32_t *out_twc_last, uint8_t *out_strand)
{
    if ((size_t)((slot_count + 7) / 8) > es->sx_seen_cap) {
        free(es->sx_seen);
        es->sx_seen_cap = (size_t)((slot_count + 7) / 8);
        es->sx_seen = (uint8_t *)calloc(es->sx_seen_cap, 1);
    }
    int32_t *ti_buf = (int32_t *)malloc((size_t)boots * 4 *
                                        sizeof(int32_t));
    int32_t *u_buf = ti_buf + boots;
    int32_t *ids2 = ti_buf + 2 * boots;
    int32_t *cnts2 = ti_buf + 3 * boots;
    uint8_t *rc = NULL;
    size_t rc_cap = 0;
    int64_t pow_w = 1;
    for (uint32_t k = 1; k < wlen; ++k)
        pow_w *= alpha_size;
    for (int64_t qi = 0; qi < n_q; ++qi) {
        const uint8_t *seq = qcat + q_off[qi];
        int64_t L = q_off[qi + 1] - q_off[qi];
        int n_str = strand_both ? 2 : 1;
        int32_t twc_s[2] = {0, 0};
        int32_t ntax_s[2] = {0, 0};
        for (int s = 0; s < n_str; ++s) {
            const uint8_t *sp = seq;
            if (s == 1) {
                if ((size_t)L > rc_cap) {
                    free(rc);
                    rc_cap = (size_t)L * 2 + 64;
                    rc = (uint8_t *)malloc(rc_cap);
                }
                for (int64_t i = 0; i < L; ++i)
                    rc[i] = comp[seq[L - 1 - i]];
                sp = rc;
            }
            /* unique words, first-occurrence order */
            if ((size_t)L + 1 > es->sx_uw_cap) {
                free(es->sx_uw);
                es->sx_uw_cap = (size_t)L * 2 + 64;
                es->sx_uw = (int64_t *)malloc(es->sx_uw_cap *
                                              sizeof(int64_t));
            }
            int64_t *uw = es->sx_uw;
            uint8_t *seen = es->sx_seen;
            uint32_t nuw = 0;
            int64_t word = 0;
            uint32_t run = 0;
            for (int64_t i = 0; i < L; ++i) {
                uint8_t let = ctl[sp[i]];
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
                    if (!(seen[word >> 3] & (1u << (word & 7)))) {
                        seen[word >> 3] |= (uint8_t)(1u << (word & 7));
                        uw[nuw++] = word;
                    }
                }
            }
            for (uint32_t k = 0; k < nuw; ++k)
                seen[uw[k] >> 3] = 0;
            if (nuw < 8)
                continue;    /* classify() returns before any RNG use */
            int m = subset_divide ? (int)(nuw / (uint32_t)boot_subset)
                                  : boot_subset;
            int32_t twc = 0;
            /* fwd writes the output slot directly; rc goes to scratch
             * and is copied in only when it strictly wins the vote */
            int32_t *ids_dst = (s == 0)
                ? out_ids + (size_t)qi * boots : ids2;
            int32_t *cnts_dst = (s == 0)
                ? out_cnts + (size_t)qi * boots : cnts2;
            ntax_s[s] = (int32_t)sintax_boots_c(
                es, uw, nuw, starts, postings, seq_count, boots, m,
                r0, grand_x, tax_id, ti_buf, u_buf,
                ids_dst, cnts_dst, &twc);
            twc_s[s] = twc;
        }
        /* OnQueryDoneImpl: fwd wins ties; the '*'-row check uses the
         * LAST classified strand's top word count */
        int use_fwd = twc_s[0] >= twc_s[1];
        if (!use_fwd) {
            memcpy(out_ids + (size_t)qi * boots, ids2,
                   (size_t)ntax_s[1] * sizeof(int32_t));
            memcpy(out_cnts + (size_t)qi * boots, cnts2,
                   (size_t)ntax_s[1] * sizeof(int32_t));
        }
        out_ntax[qi] = use_fwd ? ntax_s[0] : ntax_s[1];
        out_twc_last[qi] = strand_both ? twc_s[1] : twc_s[0];
        out_strand[qi] = use_fwd ? '+' : '-';
    }
    free(ti_buf);
    free(rc);
    return n_q;
}

/* ---- usearch_local AlignMulti target scan (src/localmulti.cpp:9-118) --
 * Scan target words; at a seed hit try each query position in
 * ascending order; a kept hit advances the scan to HSP.hij+1; a
 * LargeOverlap discard falls through to the next query position.
 * Query words arrive pre-sorted with their stable position order
 * (LocalAligner2::SetQueryImpl).  Target words roll with wildcards
 * degraded to letter 0.  Returns kept-hit count (or -3 when path_buf
 * is too small; caller grows and retries). */
typedef struct XDScratch XDScratch;
extern int local_align_pos(XDScratch *s, const byte *Q, uint32_t ql,
                           const byte *T, uint32_t tl, uint32_t qpos,
                           uint32_t tpos, const float *mx, float xdrop_u,
                           float xdrop_g, float open_p, float ext_p,
                           float min_ungapped_score,
                           double gapped_lambda, double log_gapped_k,
                           double db_size, double max_evalue,
                           uint32_t *hsp_out, float *score_out,
                           double *evalue_out, char *path_out);
extern double score_local_path_c(const uint8_t *q, const uint8_t *t,
                                 const char *path, int64_t n,
                                 const float *mx, float open_p,
                                 float ext_p);

static int64_t lm_lower_bound(const int64_t *a, int64_t n, int64_t key)
{
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (a[mid] < key)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

int64_t local_multi_c(
    XDScratch *s, EngineScratch *es,
    const uint8_t *q, int64_t ql, const uint8_t *t, int64_t tl,
    const int64_t *q_sorted_words, const int64_t *q_pos_order,
    int64_t n_qw,
    const uint8_t *ctl, int64_t alpha_size, int64_t wlen,
    const float *mx,
    double xdrop_u, double xdrop_g, double local_open, double local_ext,
    double min_ungapped,
    double gapped_lambda, double log_gapped_k, double db_size,
    double max_evalue,
    int64_t max_hits,
    int32_t *out_hsp, double *out_raw,
    char *path_buf, int64_t path_cap, int64_t *path_off)
{
    if (tl < 2 * wlen)
        return 0;
    int64_t n_tw = tl - wlen + 1;
    /* rolling target words, wildcards -> 0 */
    if ((size_t)n_tw > es->sx_uw_cap) {
        free(es->sx_uw);
        es->sx_uw_cap = (size_t)n_tw * 2 + 64;
        es->sx_uw = (int64_t *)malloc(es->sx_uw_cap * sizeof(int64_t));
    }
    int64_t *tw = es->sx_uw;
    {
        int64_t pw = 1;
        for (int64_t k = 1; k < wlen; ++k)
            pw *= alpha_size;
        int64_t word = 0;
        for (int64_t i = 0; i < tl; ++i) {
            int64_t let = ctl[t[i]];
            if (let >= alpha_size)
                let = 0;
            if (i >= wlen)
                word -= (word / pw) * pw;
            word = word * alpha_size + let;
            if (i >= wlen - 1)
                tw[i - wlen + 1] = word;
        }
    }
    int64_t n_hits = 0;
    int64_t ppos = 0;
    uint32_t hsp_out[4];
    float score;
    double evalue;
    char *tmp_path = es->path;
    if ((size_t)(2 * (ql + tl) + 16) > es->path_cap) {
        free(es->path);
        es->path_cap = (size_t)(2 * (ql + tl) + 16) * 2;
        es->path = (char *)malloc(es->path_cap);
        tmp_path = es->path;
    }
    path_off[0] = 0;
    int64_t tpos = 0;
    while (tpos < n_tw) {
        int64_t key = tw[tpos];
        int64_t lo = lm_lower_bound(q_sorted_words, n_qw, key);
        int64_t hi = lm_lower_bound(q_sorted_words, n_qw, key + 1);
        int kept_here = 0;
        for (int64_t kk = lo; kk < hi; ++kk) {
            int64_t qpos = q_pos_order[kk];
            if (!local_align_pos(s, q, (uint32_t)ql, t, (uint32_t)tl,
                                 (uint32_t)qpos, (uint32_t)tpos, mx,
                                 (float)xdrop_u, (float)xdrop_g,
                                 (float)local_open, (float)local_ext,
                                 (float)min_ungapped,
                                 gapped_lambda, log_gapped_k, db_size,
                                 max_evalue, hsp_out, &score, &evalue,
                                 tmp_path))
                continue;
            int64_t loi = hsp_out[0], loj = hsp_out[1];
            int64_t leni = hsp_out[2], lenj = hsp_out[3];
            int64_t hii = loi + leni - 1, hij = loj + lenj - 1;
            /* LargeOverlap vs kept hits (OverlapFract > 0.5) */
            int large = 0;
            for (int64_t h = 0; h < n_hits; ++h) {
                int64_t kloi = out_hsp[4 * h], kloj = out_hsp[4 * h + 1];
                int64_t kleni = out_hsp[4 * h + 2];
                int64_t klenj = out_hsp[4 * h + 3];
                if (leni == 0 || lenj == 0)
                    break;
                int64_t khii = kloi + kleni - 1;
                int64_t khij = kloj + klenj - 1;
                int64_t mlo_i = loi > kloi ? loi : kloi;
                int64_t mlo_j = loj > kloj ? loj : kloj;
                int64_t mhi_i = hii < khii ? hii : khii;
                int64_t mhi_j = hij < khij ? hij : khij;
                int64_t ovi = mhi_i < mlo_i ? 0 : mhi_i - mlo_i;
                int64_t ovj = mhi_j < mlo_j ? 0 : mhi_j - mlo_j;
                double fract = (double)(ovi * ovj)
                    / (double)(leni * lenj);
                if (fract > 0.5) {
                    large = 1;
                    break;
                }
            }
            if (large)
                continue;
            if (n_hits >= max_hits)
                return -4;        /* caller retries with bigger arrays */
            int64_t plen = (int64_t)strlen(tmp_path);
            if (ppos + plen > path_cap)
                return -3;
            memcpy(path_buf + ppos, tmp_path, (size_t)plen);
            ppos += plen;
            out_hsp[4 * n_hits] = (int32_t)loi;
            out_hsp[4 * n_hits + 1] = (int32_t)loj;
            out_hsp[4 * n_hits + 2] = (int32_t)leni;
            out_hsp[4 * n_hits + 3] = (int32_t)lenj;
            double raw = score_local_path_c(q + loi, t + loj, tmp_path,
                                            plen, mx, (float)local_open,
                                            (float)local_ext);
            out_raw[n_hits] = (double)(float)raw;
            ++n_hits;
            path_off[n_hits] = ppos;
            int64_t new_tpos = hij + 1;
            tpos = new_tpos > tpos ? new_tpos : tpos + 1;
            kept_here = 1;
            break;
        }
        if (!kept_here)
            ++tpos;
    }
    return n_hits;
}

/* ---- LocalAligner2::SetQueryImpl word dictionary ----------------------
 * Rolling query words (wildcards -> 0) sorted by word with stable
 * position order — a counting sort over the small word space, exactly
 * np.argsort(kind='stable').  Returns n words. */
int64_t local_setq_c(const uint8_t *q, int64_t ql,
                     const uint8_t *ctl, int64_t alpha_size, int64_t wlen,
                     int64_t *out_sorted_words, int64_t *out_pos_order)
{
    if (ql < wlen)
        return 0;
    int64_t n = ql - wlen + 1;
    int64_t nslots = 1;
    for (int64_t k = 0; k < wlen; ++k)
        nslots *= alpha_size;
    int64_t *words = (int64_t *)malloc((size_t)n * sizeof(int64_t));
    int64_t *cnt = (int64_t *)calloc((size_t)nslots + 1, sizeof(int64_t));
    int64_t pw = 1;
    for (int64_t k = 1; k < wlen; ++k)
        pw *= alpha_size;
    int64_t word = 0;
    for (int64_t i = 0; i < ql; ++i) {
        int64_t let = ctl[q[i]];
        if (let >= alpha_size)
            let = 0;
        if (i >= wlen)
            word -= (word / pw) * pw;
        word = word * alpha_size + let;
        if (i >= wlen - 1) {
            words[i - wlen + 1] = word;
            ++cnt[word + 1];
        }
    }
    for (int64_t w = 0; w < nslots; ++w)
        cnt[w + 1] += cnt[w];
    for (int64_t i = 0; i < n; ++i) {
        int64_t w = words[i];
        int64_t slot = cnt[w]++;
        out_sorted_words[slot] = w;
        out_pos_order[slot] = i;
    }
    free(words);
    free(cnt);
    return n;
}

/* ---- usearch_local per-query driver -----------------------------------
 * Rank order is supplied by the caller; per candidate target this runs
 * the AlignMulti scan (local_multi_c), applies the -id/-maxid accept
 * gate per AR (fract id = id_count/aln_length over the local path,
 * matching AlignResult::GetFractId), feeds the counter terminator with
 * any-AR-accepted per target, and emits accepted hits.
 * Returns the number of emitted hits; -3/-4 = grow path/hit buffers. */
extern int64_t local_multi_c(
    XDScratch *s, EngineScratch *es,
    const uint8_t *q, int64_t ql, const uint8_t *t, int64_t tl,
    const int64_t *q_sorted_words, const int64_t *q_pos_order,
    int64_t n_qw,
    const uint8_t *ctl, int64_t alpha_size, int64_t wlen,
    const float *mx,
    double xdrop_u, double xdrop_g, double local_open, double local_ext,
    double min_ungapped,
    double gapped_lambda, double log_gapped_k, double db_size,
    double max_evalue,
    int64_t max_hits,
    int32_t *out_hsp, double *out_raw,
    char *path_buf, int64_t path_cap, int64_t *path_off);
extern int64_t local_setq_c(const uint8_t *q, int64_t ql,
                            const uint8_t *ctl, int64_t alpha_size,
                            int64_t wlen,
                            int64_t *out_sorted_words,
                            int64_t *out_pos_order);

int64_t local_query_c(
    XDScratch *xs, EngineScratch *es,
    const uint8_t *q, int64_t ql,
    const uint8_t *cat, const int64_t *offs,
    const uint32_t *tix_order, int64_t n_cand,
    const uint8_t *ctl, int64_t alpha_size, int64_t wlen,
    const float *mx, const uint8_t *match_mx,
    double xdrop_u, double xdrop_g, double local_open, double local_ext,
    double min_ungapped, double gapped_lambda, double log_gapped_k,
    double db_size, double max_evalue,
    double min_id, int64_t has_min_id, double max_id, int64_t has_max_id,
    int32_t max_accepts, int32_t max_rejects,
    int64_t max_hits,
    int32_t *out_tix, int32_t *out_hsp, double *out_raw,
    char *path_buf, int64_t path_cap, int64_t *path_off)
{
    if (ql <= wlen)
        return 0;
    int64_t n_qw = ql - wlen + 1;
    int64_t *sw = (int64_t *)malloc((size_t)n_qw * 2 * sizeof(int64_t));
    int64_t *qo = sw + n_qw;
    local_setq_c(q, ql, ctl, alpha_size, wlen, sw, qo);

    /* per-target scratch */
    enum { TMAX = 64 };
    int32_t t_hsp[TMAX * 4];
    double t_raw[TMAX];
    int64_t t_poff[TMAX + 1];
    size_t t_pcap = 1 << 16;
    char *t_paths = (char *)malloc(t_pcap);

    int32_t accepts = 0, rejects = 0;
    int64_t n_out = 0, ppos = 0;
    int64_t rc = 0;
    path_off[0] = 0;
    for (int64_t c = 0; c < n_cand; ++c) {
        int32_t tix = (int32_t)tix_order[c];
        const uint8_t *t = cat + offs[tix];
        int64_t tl = offs[tix + 1] - offs[tix];
        int64_t nh;
        for (;;) {
            nh = local_multi_c(xs, es, q, ql, t, tl, sw, qo, n_qw,
                               ctl, alpha_size, wlen, mx,
                               xdrop_u, xdrop_g, local_open, local_ext,
                               min_ungapped, gapped_lambda, log_gapped_k,
                               db_size, max_evalue,
                               TMAX, t_hsp, t_raw,
                               t_paths, (int64_t)t_pcap, t_poff);
            if (nh == -3) {
                t_pcap *= 2;
                free(t_paths);
                t_paths = (char *)malloc(t_pcap);
                continue;
            }
            break;
        }
        if (nh < 0) {         /* -4: too many hits on one target */
            rc = -4;
            break;
        }
        int any_accept = 0;
        for (int64_t h = 0; h < nh; ++h) {
            const char *path = t_paths + t_poff[h];
            int64_t plen = t_poff[h + 1] - t_poff[h];
            /* aln stats over the local path */
            int64_t first_m = -1, last_m = -1;
            int64_t qi = t_hsp[4 * h], tj = t_hsp[4 * h + 1];
            int64_t ids = 0;
            for (int64_t k = 0; k < plen; ++k) {
                char pc = path[k];
                if (pc == 'M') {
                    if (first_m < 0)
                        first_m = k;
                    last_m = k;
                    if (match_mx[256 * (size_t)q[qi] + t[tj]])
                        ++ids;
                }
                if (pc == 'M' || pc == 'D')
                    ++qi;
                if (pc == 'M' || pc == 'I')
                    ++tj;
            }
            int64_t alnlen = (first_m < 0) ? 0 : last_m - first_m + 1;
            double fract = alnlen ? (double)ids / (double)alnlen : 0.0;
            int accept = 1;
            if (has_min_id && fract < min_id)
                accept = 0;
            if (accept && has_max_id && fract > max_id)
                accept = 0;
            if (!accept)
                continue;
            any_accept = 1;
            if (n_out >= max_hits || ppos + plen > path_cap) {
                rc = -5;      /* caller grows output arrays */
                break;
            }
            out_tix[n_out] = tix;
            memcpy(out_hsp + 4 * n_out, t_hsp + 4 * h,
                   4 * sizeof(int32_t));
            out_raw[n_out] = t_raw[h];
            memcpy(path_buf + ppos, path, (size_t)plen);
            ppos += plen;
            ++n_out;
            path_off[n_out] = ppos;
        }
        if (rc < 0)
            break;
        if (any_accept)
            ++accepts;
        else
            ++rejects;
        if (max_accepts > 0 && accepts == max_accepts)
            break;
        if (max_rejects > 0 && rejects == max_rejects)
            break;
    }
    free(sw);
    free(t_paths);
    return rc < 0 ? rc : n_out;
}

/* ---------------------------------------------------------------- */
/* blast6 fast emitter: format a whole window's blast6 lines straight
 * from the packed hit arrays (semantics of engine/emit.py
 * Blast6Emitter / out/blast6.py, i.e. src/blast6out.cpp:27-103 for
 * global search: qlo..qhi = 1..LA, tlo/thi flipped for a revcomp
 * query, evalue/bitscore = '*').
 *
 * Hit order per record replays HitMgr's QuickSortOrderDesc over
 * float32 fract-id (src/sort.h:62-101, Hoare partition, middle
 * pivot) -- identical swap sequence => identical tie ordering. */

static void b6_order_qsort(const float *sc, int32_t *order, int left,
                           int right)
{
    int i = left, j = right;
    float pivot = sc[order[(left + right) / 2]];
    while (i <= j) {
        while (sc[order[i]] > pivot) ++i;
        while (sc[order[j]] < pivot) --j;
        if (i <= j) {
            int32_t t = order[i]; order[i] = order[j]; order[j] = t;
            ++i; --j;
        }
    }
    if (left < j) b6_order_qsort(sc, order, left, j);
    if (i < right) b6_order_qsort(sc, order, i, right);
}

/* Returns bytes written, or -1 if out_cap would overflow (caller grows
 * the buffer and retries).  job_start is the per-job prefix (len
 * n_jobs+1) into the job-sorted hit arrays; jobs of record r are
 * r*jobs_per_rec .. +jobs_per_rec-1, job 2r+1 = revcomp strand. */
int64_t blast6_emit_c(
    const uint8_t *raw, const int64_t *lbl_off, const int64_t *lbl_end,
    int64_t nrec, int32_t jobs_per_rec, const int64_t *j_off,
    const int32_t *hit_job_unused, const uint32_t *hit_tix,
    const int64_t *hit_stats, const int64_t *job_start,
    const uint8_t *tlbl_buf, const int64_t *tlbl_off,
    const int64_t *tlen, int32_t output_no_hits,
    char *out, int64_t out_cap)
{
    (void)hit_job_unused;
    int64_t pos = 0;
    int64_t n_jobs = nrec * jobs_per_rec;
    int64_t max_hits = job_start[n_jobs];
    int cap_local = 8;
    int32_t ord_local[8];
    int32_t rc_local[8];
    int64_t idx_local[8], la_local[8];
    float sc_local[8];
    int32_t *ord = ord_local, *rcf = rc_local;
    int64_t *idx = idx_local, *la = la_local;
    float *sc = sc_local;
    int heap = 0;
    for (int64_t r = 0; r < nrec; ++r) {
        int64_t j0 = r * jobs_per_rec;
        int n = 0;
        for (int s = 0; s < jobs_per_rec; ++s)
            n += (int)(job_start[j0 + s + 1] - job_start[j0 + s]);
        int64_t llen = lbl_end[r] - lbl_off[r];
        if (n == 0) {
            if (!output_no_hits)
                continue;
            if (pos + llen + 64 > out_cap)
                goto overflow;
            memcpy(out + pos, raw + lbl_off[r], (size_t)llen);
            pos += llen;
            pos += sprintf(out + pos,
                           "\t*\t0\t0\t0\t0\t0\t0\t0\t0\t*\t0\n");
            continue;
        }
        if (n > cap_local && !heap) {
            ord = (int32_t *)malloc((size_t)max_hits * sizeof(int32_t));
            rcf = (int32_t *)malloc((size_t)max_hits * sizeof(int32_t));
            idx = (int64_t *)malloc((size_t)max_hits * sizeof(int64_t));
            la = (int64_t *)malloc((size_t)max_hits * sizeof(int64_t));
            sc = (float *)malloc((size_t)max_hits * sizeof(float));
            heap = 1;
        }
        int k = 0;
        for (int s = 0; s < jobs_per_rec; ++s) {
            int64_t j = j0 + s;
            int64_t ja = j_off[j + 1] - j_off[j];
            for (int64_t h = job_start[j]; h < job_start[j + 1]; ++h) {
                idx[k] = h;
                rcf[k] = s == 1;
                la[k] = ja;
                const int64_t *st = hit_stats + 10 * h;
                sc[k] = (float)((double)st[6]
                                / (double)(st[1] - st[0] + 1));
                ord[k] = k;
                ++k;
            }
        }
        if (n > 1)
            b6_order_qsort(sc, ord, 0, n - 1);
        for (int m = 0; m < n; ++m) {
            int kk = ord[m];
            int64_t h = idx[kk];
            uint32_t tix = hit_tix[h];
            const int64_t *st = hit_stats + 10 * h;
            int64_t alnlen = st[1] - st[0] + 1;
            int64_t tl_len = tlbl_off[tix + 1] - tlbl_off[tix];
            if (pos + llen + tl_len + 192 > out_cap)
                goto overflow;
            memcpy(out + pos, raw + lbl_off[r], (size_t)llen);
            pos += llen;
            out[pos++] = '\t';
            memcpy(out + pos, tlbl_buf + tlbl_off[tix], (size_t)tl_len);
            pos += tl_len;
            int64_t lb = tlen[tix];
            int64_t tlo = rcf[kk] ? lb : 1, thi = rcf[kk] ? 1 : lb;
            pos += sprintf(out + pos,
                           "\t%.1f\t%lld\t%lld\t%lld\t1\t%lld\t%lld\t"
                           "%lld\t*\t*\n",
                           100.0 * ((double)st[6] / (double)alnlen),
                           (long long)alnlen, (long long)(st[8] - st[6]),
                           (long long)st[9], (long long)la[kk],
                           (long long)tlo, (long long)thi);
        }
    }
    if (heap) { free(ord); free(rcf); free(idx); free(la); free(sc); }
    return pos;
overflow:
    if (heap) { free(ord); free(rcf); free(idx); free(la); free(sc); }
    return -1;
}

/* uc H/S record emission for the greedy cluster engine (fast path:
 * every record has at most one hit, the cluster_fast/cluster_smallmem
 * default with maxaccepts 1).  Mirrors engine/cluster.py
 * _write_outputs' uc loop byte-for-byte, including the derep member
 * expansion lines.  Returns bytes written, or -1 on out overflow. */
int64_t cluster_uc_emit_c(
    int64_t n, const int64_t *order,
    const uint8_t *ulab_buf, const int64_t *ulab_off,
    const int64_t *ulen,
    const int32_t *out_assign, const int64_t *out_hit_off,
    const int32_t *hit_tix, const uint8_t *hit_rc,
    const double *hit_pct,
    const int64_t *hit_cpath_off, const uint8_t *cpath_buf,
    const int64_t *centroid_ui,
    const int64_t *memb_off, const int64_t *memb_idx,
    const uint8_t *ilab_buf, const int64_t *ilab_off,
    int32_t nucleo, char *out, int64_t out_cap)
{
    int64_t pos = 0;
    for (int64_t q = 0; q < n; ++q) {
        int64_t ui = order[q];
        const uint8_t *ql = ulab_buf + ulab_off[ui];
        int64_t qn = ulab_off[ui + 1] - ulab_off[ui];
        int64_t la = ulen[ui];
        int64_t lo = out_hit_off[q], hi = out_hit_off[q + 1];
        if (hi > lo) {
            int64_t h = lo;   /* fast path: exactly one hit */
            char strand = nucleo ? (hit_rc[h] ? '-' : '+') : '.';
            const uint8_t *cp = cpath_buf + hit_cpath_off[h];
            int64_t cpn = hit_cpath_off[h + 1] - hit_cpath_off[h];
            int64_t ci = hit_tix[h];
            int64_t cui = centroid_ui[ci];
            const uint8_t *tl = ulab_buf + ulab_off[cui];
            int64_t tn = ulab_off[cui + 1] - ulab_off[cui];
            int64_t m0 = memb_off ? memb_off[ui] : 0;
            int64_t m1 = memb_off ? memb_off[ui + 1] : 0;
            int64_t need = (qn + tn + cpn + 96);
            if (memb_off)
                for (int64_t m = m0 + 1; m < m1; ++m)
                    need += (ilab_off[memb_idx[m] + 1]
                             - ilab_off[memb_idx[m]]) + tn + cpn + 96;
            if (pos + need > out_cap)
                return -1;
            pos += sprintf(out + pos, "H\t%lld\t%lld\t%.1f\t%c\t0\t0\t",
                           (long long)ci, (long long)la, hit_pct[h],
                           strand);
            memcpy(out + pos, cp, (size_t)cpn); pos += cpn;
            out[pos++] = '\t';
            memcpy(out + pos, ql, (size_t)qn); pos += qn;
            out[pos++] = '\t';
            memcpy(out + pos, tl, (size_t)tn); pos += tn;
            out[pos++] = '\n';
            if (memb_off) {
                for (int64_t m = m0 + 1; m < m1; ++m) {
                    int64_t si = memb_idx[m];
                    const uint8_t *il = ilab_buf + ilab_off[si];
                    int64_t in_ = ilab_off[si + 1] - ilab_off[si];
                    pos += sprintf(out + pos,
                                   "H\t%lld\t%lld\t%.1f\t%c\t0\t0\t",
                                   (long long)ci, (long long)la,
                                   hit_pct[h], strand);
                    memcpy(out + pos, cp, (size_t)cpn); pos += cpn;
                    out[pos++] = '\t';
                    memcpy(out + pos, il, (size_t)in_); pos += in_;
                    out[pos++] = '\t';
                    memcpy(out + pos, tl, (size_t)tn); pos += tn;
                    out[pos++] = '\n';
                }
            }
        } else {
            int64_t ci = out_assign[q];
            int64_t m0 = memb_off ? memb_off[ui] : 0;
            int64_t m1 = memb_off ? memb_off[ui + 1] : 0;
            int64_t need = qn + 64;
            if (memb_off)
                for (int64_t m = m0 + 1; m < m1; ++m)
                    need += (ilab_off[memb_idx[m] + 1]
                             - ilab_off[memb_idx[m]]) + qn + 96;
            if (pos + need > out_cap)
                return -1;
            pos += sprintf(out + pos, "S\t%lld\t%lld\t*\t.\t*\t*\t*\t",
                           (long long)ci, (long long)la);
            memcpy(out + pos, ql, (size_t)qn); pos += qn;
            out[pos++] = '\t'; out[pos++] = '*'; out[pos++] = '\n';
            if (memb_off) {
                for (int64_t m = m0 + 1; m < m1; ++m) {
                    int64_t si = memb_idx[m];
                    const uint8_t *il = ilab_buf + ilab_off[si];
                    int64_t in_ = ilab_off[si + 1] - ilab_off[si];
                    pos += sprintf(out + pos,
                                   "H\t%lld\t%lld\t100.0\t.\t0\t%lld\t=\t",
                                   (long long)ci, (long long)la,
                                   (long long)la);
                    memcpy(out + pos, il, (size_t)in_); pos += in_;
                    out[pos++] = '\t';
                    memcpy(out + pos, ql, (size_t)qn); pos += qn;
                    out[pos++] = '\n';
                }
            }
        }
    }
    return pos;
}
