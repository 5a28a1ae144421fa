// Pipelined multi-threaded PAF loader: the port's copy of the JAX
// package's io/native/pafmt.cpp.
//
//   reader thread:  gzread 8 MB blocks, snapped to newline boundaries
//   parser workers: tokenize + span/match filter + CHUNK-LOCAL name
//                   interning (small cache-resident dicts), out of order
//   consumer (the ctypes caller, GIL released): globalizes chunks IN
//                   ORDER — resolves the 10-field bl-carry across chunk
//                   boundaries, maps local -> global ids, and fills the
//                   caller's piece buffer (the flat FMT3 layout, the
//                   4-row packed or the 7-row column layout) in place,
//                   while the workers parse ahead
//
// Chunk-local interning keeps the hot dict small; the sequential
// globalization pass costs one hash op per (chunk, distinct name), which
// preserves the reference's exact id semantics: ids are assigned in first
// appearance order over surviving lines, query name before target name
// (sd_put calls in hit.c:87-88).  Proof that local order composes: a name
// globally new in chunk k is also locally new there, and the relative
// order of two globally-new names equals their local first-appearance
// order, which is the local id order.
//
// Reference semantics reproduced (paf.c:34-67, hit.c:70-107):
//   - lines with <10 tab-separated fields are skipped (and do not touch
//     the bl carry);
//   - a line with exactly 10 fields reuses the previous parsed line's bl
//     (the reference reuses the caller's struct across paf_read calls) —
//     across chunk AND thread boundaries here, resolved at globalization;
//   - records failing qe-qs/te-ts < min_span or ml < min_match are
//     dropped BEFORE interning; the optional exclusion set (-R) drops by
//     name before interning;
//   - read length is recorded at a name's first surviving appearance.

#include <unistd.h>
#include <zlib.h>

#include <cerrno>
#include <charconv>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" void ma_radix_argsort_u64(uint64_t*, int64_t*, int64_t);

namespace {

struct Arena {
    std::vector<char*> blocks;
    size_t used = 0, cap = 0;
    Arena() = default;
    Arena(Arena&& o) noexcept
        : blocks(std::move(o.blocks)), used(o.used), cap(o.cap) {
        o.blocks.clear();
        o.used = o.cap = 0;
    }
    Arena(const Arena&) = delete;
    Arena& operator=(const Arena&) = delete;
    const char* intern(const char* s, size_t len) {
        if (used + len + 1 > cap) {
            cap = 1 << 20;
            if (len + 1 > cap) cap = len + 1;
            blocks.push_back(static_cast<char*>(std::malloc(cap)));
            used = 0;
        }
        char* dst = blocks.back() + used;
        std::memcpy(dst, s, len);
        dst[len] = 0;
        used += len + 1;
        return dst;
    }
    ~Arena() {
        for (char* b : blocks) std::free(b);
    }
};

struct Block {
    int64_t seq = -1;
    std::string data;  // whole lines only
};

// Open-addressing string -> id map (linear probing, 64-bit mixed hash).
// The interning path does one lookup per line (27.6M at worm scale), and
// std::unordered_map's node allocations + std::hash dominated the parse
// (measured: tokenize+filter alone is ~1.0 s, the full parse was ~5x
// that).  Insertion order semantics are identical: ids are assigned in
// first-appearance order by the caller.
struct FlatDict {
    std::vector<uint64_t> hs;
    std::vector<int32_t> ids;
    std::vector<const char*> keys;
    std::vector<uint32_t> lens;
    size_t mask = 0, used = 0;

    void init(size_t want) {
        size_t c = 16;
        while (c < want * 2) c <<= 1;
        hs.assign(c, 0);
        ids.assign(c, -1);
        keys.assign(c, nullptr);
        lens.assign(c, 0);
        mask = c - 1;
        used = 0;
    }
    static inline uint64_t hsh(const char* s, size_t len) {
        uint64_t h = 0x9E3779B97F4A7C15ull ^
                     (static_cast<uint64_t>(len) * 0xff51afd7ed558ccdull);
        while (len >= 8) {
            uint64_t k;
            std::memcpy(&k, s, 8);
            k *= 0xff51afd7ed558ccdull;
            k = (k << 31) | (k >> 33);
            h = (h ^ k) * 0xc4ceb9fe1a85ec53ull;
            s += 8;
            len -= 8;
        }
        uint64_t k = 0;
        for (size_t i = 0; i < len; ++i)
            k |= static_cast<uint64_t>(static_cast<unsigned char>(s[i]))
                 << (8 * i);
        h = (h ^ (k * 0xff51afd7ed558ccdull)) * 0xc4ceb9fe1a85ec53ull;
        h ^= h >> 29;
        return h | 1;  // 0 marks an empty slot
    }
    // find the slot for (s, len); returns the id or -1 (slot_out set for
    // the subsequent put)
    inline int32_t find(const char* s, size_t len, uint64_t h,
                        size_t* slot_out) const {
        size_t i = h & mask;
        for (;;) {
            if (hs[i] == 0) {
                *slot_out = i;
                return -1;
            }
            if (hs[i] == h && lens[i] == len &&
                std::memcmp(keys[i], s, len) == 0)
                return ids[i];
            i = (i + 1) & mask;
        }
    }
    inline void put(size_t slot, uint64_t h, const char* stable, size_t len,
                    int32_t id) {
        hs[slot] = h;
        ids[slot] = id;
        keys[slot] = stable;
        lens[slot] = static_cast<uint32_t>(len);
        if (++used * 10 >= (mask + 1) * 7) grow();
    }
    void grow() {
        std::vector<uint64_t> oh;
        std::vector<int32_t> oi;
        std::vector<const char*> ok;
        std::vector<uint32_t> ol;
        oh.swap(hs);
        oi.swap(ids);
        ok.swap(keys);
        ol.swap(lens);
        size_t c = (mask + 1) * 2;
        hs.assign(c, 0);
        ids.assign(c, -1);
        keys.assign(c, nullptr);
        lens.assign(c, 0);
        mask = c - 1;
        for (size_t j = 0; j < oh.size(); ++j) {
            if (oh[j] == 0) continue;
            size_t i = oh[j] & mask;
            while (hs[i] != 0) i = (i + 1) & mask;
            hs[i] = oh[j];
            ids[i] = oi[j];
            keys[i] = ok[j];
            lens[i] = ol[j];
        }
    }
};

struct Chunk {
    int64_t seq = -1;
    int64_t n_lines = 0;
    // stored records, chunk-local ids
    std::vector<int32_t> qid, tid;
    std::vector<uint32_t> qs, qe, ts, te, ml, bl;
    std::vector<uint8_t> rev;
    std::vector<int64_t> blmiss;  // record idx with bl unknown at parse time
    bool has_bl = false;
    uint32_t tail_bl = 0;
    // local name table (id order = local first appearance)
    std::vector<const char*> names;
    std::vector<uint32_t> name_len;
    std::vector<uint32_t> seq_len;
    Arena arena;
};

struct MtState {
    gzFile fp = nullptr;
    int64_t min_span, min_match;
    int bi_dir;
    float iden_f;
    int64_t chunk_recs;
    int64_t block_bytes = 0;  // 0 = default 8 MB; tests shrink it
    std::unordered_set<std::string> excl;

    // block queue (reader -> workers)
    std::mutex bmx;
    std::condition_variable bcv_push, bcv_pop;
    std::vector<Block> bq;
    bool read_done = false;
    bool aborted = false;

    // ordered chunk results (workers -> consumer)
    std::mutex cmx;
    std::condition_variable ccv;
    std::unordered_map<int64_t, Chunk*> done;
    int64_t next_emit = 0;   // chunk seq the consumer wants next
    int64_t n_chunks = -1;   // set when the reader finishes
    bool abort_flag = false;

    std::vector<std::thread> threads;

    // consumer state (globalization)
    FlatDict gdict;
    std::vector<const char*> gnames;
    std::vector<uint32_t> gname_len;
    std::vector<uint32_t> gseq_len;
    std::vector<Arena*> arenas;  // chunk arenas kept alive (names point in)
    uint32_t carry_bl = 0;
    // carry-over records whose bl resolves in a later... (never: bl comes
    // from EARLIER lines only, so a chunk is always resolvable on arrival)
    int64_t n_orig = 0, n_mirror = 0, n_lines = 0;
    uint32_t max_len = 0;
    // retained global columns for the exact-rank build
    std::vector<int32_t> g_qid, g_tid;
    std::vector<uint32_t> g_qs, g_ts;
    // full-record retention (-p paf replay): qe/te/ml/bl/rev too
    bool retain_full = false;
    std::vector<uint32_t> g_qe, g_te, g_ml, g_bl;
    std::vector<uint8_t> g_rev;
    // pending: partially-consumed chunk
    Chunk* cur = nullptr;
    int64_t cur_off = 0;
    std::vector<int32_t> cur_gmap;  // local id -> global id for cur

    int64_t* rank = nullptr;
    std::string names_blob;
    bool pack_fail = false;  // a record didn't fit the 4-row packed piece
    bool rle_fail = false;   // a piece overflowed the FMT3 qid-RLE sideband

    ~MtState() {
        for (auto& kv : done) delete kv.second;
        for (Arena* a : arenas) delete a;
        if (cur) delete cur;
        std::free(rank);
        if (fp) gzclose(fp);
    }
};

void reader_main(MtState* st) {
    const size_t BLK = st->block_bytes > 0
        ? static_cast<size_t>(st->block_bytes) : (8 << 20);
    std::string carry;
    int64_t seq = 0;
    std::vector<char> buf(BLK);
    bool eof = false;
    while (!eof) {
        int nread = gzread(st->fp, buf.data(), static_cast<unsigned>(BLK));
        if (nread <= 0) eof = true;
        Block b;
        b.seq = seq;
        if (nread > 0) {
            const char* base = buf.data();
            const char* last_nl = static_cast<const char*>(
                memrchr(base, '\n', nread));
            if (last_nl) {
                b.data = std::move(carry);
                b.data.append(base, last_nl + 1 - base);
                carry.assign(last_nl + 1, base + nread - (last_nl + 1));
            } else {
                carry.append(base, nread);
                continue;  // no full line yet
            }
        } else {
            if (carry.empty()) break;
            b.data = std::move(carry);
            b.data.push_back('\n');
            carry.clear();
        }
        {
            std::unique_lock<std::mutex> lk(st->bmx);
            st->bcv_push.wait(lk, [&] {
                return st->bq.size() < 6 || st->aborted;
            });
            if (st->aborted) break;
            st->bq.push_back(std::move(b));
        }
        st->bcv_pop.notify_one();
        ++seq;
    }
    {
        std::lock_guard<std::mutex> lk(st->bmx);
        st->read_done = true;
    }
    st->bcv_pop.notify_all();
    {
        std::lock_guard<std::mutex> lk(st->cmx);
        st->n_chunks = seq;
    }
    st->ccv.notify_all();
}

inline uint32_t parse_u32(const char* s, const char* e) {
    uint32_t v = 0;
    for (; s < e; ++s) {
        unsigned c = static_cast<unsigned>(*s) - '0';
        if (c > 9) break;
        v = v * 10 + c;
    }
    return v;
}

void parse_block(MtState* st, Block& blk, Chunk* ck) {
    const char* p = blk.data.data();
    const char* end = p + blk.data.size();
    // pre-size the record columns from the block's byte count (PAF lines
    // are ~70-90 B) so the 9 per-record appends never reallocate mid-chunk
    const size_t est = blk.data.size() / 70 + 8;
    ck->qid.reserve(est);
    ck->tid.reserve(est);
    ck->qs.reserve(est);
    ck->qe.reserve(est);
    ck->ts.reserve(est);
    ck->te.reserve(est);
    ck->ml.reserve(est);
    ck->bl.reserve(est);
    ck->rev.reserve(est);
    // chunk-local interning with a previous-query fast path (PAF is
    // grouped by query, so most lines repeat the previous qname)
    FlatDict dict;
    dict.init(1 << 12);
    const char* prev_q = nullptr;
    size_t prev_qlen = 0;
    int32_t prev_qid = -1;
    auto put = [&](const char* s, size_t len, uint32_t l) -> int32_t {
        uint64_t h = FlatDict::hsh(s, len);
        size_t slot;
        int32_t got = dict.find(s, len, h, &slot);
        if (got >= 0) return got;
        const char* stable = ck->arena.intern(s, len);
        int32_t id = static_cast<int32_t>(ck->names.size());
        dict.put(slot, h, stable, len, id);
        ck->names.push_back(stable);
        ck->name_len.push_back(static_cast<uint32_t>(len));
        ck->seq_len.push_back(l);
        return id;
    };
    bool bl_known = false;
    uint32_t cur_bl = 0;
    while (p < end) {
        // memchr-driven tokenizer: the newline and tab scans ride glibc's
        // SIMD memchr (the byte-at-a-time walk was ~3.8 cycles/byte);
        // numeric conversion touches only the 8 numeric fields
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', end - p));
        if (!nl) nl = end;  // reader guarantees a trailing '\n'; guard
        const char* f[11];
        size_t flen[11];
        int t = 0;
        const char* q = p;
        while (t < 11) {
            const char* tab = static_cast<const char*>(
                std::memchr(q, '\t', nl - q));
            f[t] = q;
            if (!tab) {
                flen[t] = static_cast<size_t>(nl - q);
                ++t;
                break;
            }
            flen[t] = static_cast<size_t>(tab - q);
            ++t;
            q = tab + 1;
        }
        bool have11 = t == 11;
        if (t >= 10) {
            ++ck->n_lines;
            uint32_t blv = 0;
            bool bl_ok = true;
            if (have11) {
                blv = parse_u32(f[10], f[10] + flen[10]);
                cur_bl = blv;
                bl_known = true;
            } else if (bl_known) {
                blv = cur_bl;
            } else {
                bl_ok = false;  // resolves from the previous chunk's tail
            }
            uint32_t qsv = parse_u32(f[2], f[2] + flen[2]);
            uint32_t qev = parse_u32(f[3], f[3] + flen[3]);
            uint32_t tsv = parse_u32(f[7], f[7] + flen[7]);
            uint32_t tev = parse_u32(f[8], f[8] + flen[8]);
            uint32_t mlv = parse_u32(f[9], f[9] + flen[9]);
            if (!(qev - qsv < static_cast<uint32_t>(st->min_span) ||
                  tev - tsv < static_cast<uint32_t>(st->min_span) ||
                  mlv < static_cast<uint32_t>(st->min_match))) {
                bool drop = false;
                if (!st->excl.empty()) {
                    drop = st->excl.count(std::string(f[0], flen[0])) ||
                           st->excl.count(std::string(f[5], flen[5]));
                }
                if (!drop) {
                    uint32_t ql = parse_u32(f[1], f[1] + flen[1]);
                    uint32_t tl = parse_u32(f[6], f[6] + flen[6]);
                    int32_t qi;
                    if (prev_q && flen[0] == prev_qlen &&
                        std::memcmp(f[0], prev_q, prev_qlen) == 0) {
                        qi = prev_qid;
                    } else {
                        qi = put(f[0], flen[0], ql);
                        prev_q = ck->names[qi];
                        prev_qlen = flen[0];
                        prev_qid = qi;
                    }
                    int32_t ti = put(f[5], flen[5], tl);
                    if (!bl_ok)
                        ck->blmiss.push_back(
                            static_cast<int64_t>(ck->qid.size()));
                    ck->qid.push_back(qi);
                    ck->qs.push_back(qsv);
                    ck->qe.push_back(qev);
                    ck->tid.push_back(ti);
                    ck->ts.push_back(tsv);
                    ck->te.push_back(tev);
                    ck->ml.push_back(mlv);
                    ck->bl.push_back(blv);
                    ck->rev.push_back(flen[4] > 0 && f[4][0] == '-');
                }
            }
        }
        p = nl + 1;
    }
    ck->has_bl = bl_known;
    ck->tail_bl = cur_bl;
}

void worker_main(MtState* st) {
    while (true) {
        Block blk;
        {
            std::unique_lock<std::mutex> lk(st->bmx);
            st->bcv_pop.wait(lk, [&] {
                return !st->bq.empty() || st->read_done;
            });
            if (st->bq.empty()) return;
            blk = std::move(st->bq.front());
            st->bq.erase(st->bq.begin());
        }
        st->bcv_push.notify_one();
        auto* ck = new Chunk();
        ck->seq = blk.seq;
        parse_block(st, blk, ck);
        {
            std::unique_lock<std::mutex> lk(st->cmx);
            // bound the number of parsed-but-unconsumed chunks
            st->ccv.wait(lk, [&] {
                return ck->seq < st->next_emit + 8 || st->abort_flag;
            });
            st->done[ck->seq] = ck;
        }
        st->ccv.notify_all();
    }
}

// pull the next IN-ORDER parsed chunk and globalize it
Chunk* take_chunk(MtState* st, std::vector<int32_t>& gmap) {
    Chunk* ck = nullptr;
    {
        std::unique_lock<std::mutex> lk(st->cmx);
        st->ccv.wait(lk, [&] {
            return st->done.count(st->next_emit) ||
                   (st->n_chunks >= 0 && st->next_emit >= st->n_chunks);
        });
        auto it = st->done.find(st->next_emit);
        if (it == st->done.end()) return nullptr;  // stream exhausted
        ck = it->second;
        st->done.erase(it);
        ++st->next_emit;
    }
    st->ccv.notify_all();
    // bl carry resolution
    for (int64_t i : ck->blmiss) ck->bl[i] = st->carry_bl;
    if (ck->has_bl) st->carry_bl = ck->tail_bl;
    st->n_lines += ck->n_lines;
    // local -> global ids (one dict op per distinct name per chunk)
    if (st->gdict.mask == 0) st->gdict.init(1 << 15);
    gmap.resize(ck->names.size());
    for (size_t i = 0; i < ck->names.size(); ++i) {
        const char* nm = ck->names[i];
        size_t len = ck->name_len[i];
        uint64_t h = FlatDict::hsh(nm, len);
        size_t slot;
        int32_t got = st->gdict.find(nm, len, h, &slot);
        if (got >= 0) {
            gmap[i] = got;
        } else {
            int32_t id = static_cast<int32_t>(st->gnames.size());
            st->gdict.put(slot, h, nm, len, id);
            st->gnames.push_back(nm);
            st->gname_len.push_back(ck->name_len[i]);
            st->gseq_len.push_back(ck->seq_len[i]);
            if (ck->seq_len[i] > st->max_len) st->max_len = ck->seq_len[i];
            gmap[i] = id;
        }
    }
    return ck;
}

}  // namespace

extern "C" {

struct MaMtInfo {
    int64_t n_orig, n_mirror, n_seq, n_lines, max_len, names_bytes;
};

MtState* ma_mt_begin(const char* fn, int64_t min_span, int64_t min_match,
                     const char* excl_names, int64_t excl_bytes, int bi_dir,
                     double min_iden, int64_t chunk_recs, int n_workers,
                     int64_t block_bytes) {
    gzFile fp = (fn && std::strcmp(fn, "-") != 0) ? gzopen(fn, "r")
                                                  : gzdopen(0, "r");
    if (!fp) return nullptr;
    gzbuffer(fp, 1 << 20);
    auto* st = new MtState();
    st->fp = fp;
    st->min_span = min_span;
    st->min_match = min_match;
    st->bi_dir = bi_dir;
    st->iden_f = static_cast<float>(min_iden);
    st->chunk_recs = chunk_recs;
    st->block_bytes = block_bytes;
    for (int64_t off = 0; off < excl_bytes;) {
        size_t len = std::strlen(excl_names + off);
        st->excl.emplace(excl_names + off, len);
        off += static_cast<int64_t>(len) + 1;
    }
    st->threads.emplace_back(reader_main, st);
    for (int w = 0; w < n_workers; ++w)
        st->threads.emplace_back(worker_main, st);
    return st;
}

// Seed the 10-field bl carry (paf.c:56-60 reuses the previous line's bl)
// for range-split multi-process reads: the value of the nearest complete
// 11-field line BEFORE this process's byte range.  Must be called between
// ma_mt_begin and the first ma_mt_next/ma_mt_next3/ma_mt_next4 (the carry
// is consumed only on the consumer thread, so no lock is needed there).
void ma_mt_seed_carry(MtState* st, int64_t bl) {
    st->carry_bl = static_cast<uint32_t>(bl);
}

}  // extern "C" (reopened after the template below)

namespace {

// Shared piece-emission core.  FMT=7 emits the classic
// [qid qs qe tid ts te flags] columns; FMT=4 emits the packed
// [qid|flags<<28, tid, qs<<16|qe, ts<<16|te] columns (16 B a record
// instead of 28), which the device unpacks (unpack4, csrc/loader.cu).
// A record can ride the packed format only when its coordinates fit 16
// bits and its global ids fit 28 bits; on the first record that does
// not, the piece is cut short and st->pack_fail is set — the caller
// switches to FMT=7 pieces for the rest of the stream (already-emitted
// packed pieces stay valid).
template <int FMT>
int64_t mt_next_impl(MtState* st, int32_t* out, int64_t want) {
    const int64_t C = want > 0 ? want : st->chunk_recs;
    int64_t filled = 0;
    int32_t* R[7];
    for (int r2 = 0; r2 < (FMT == 3 ? 3 : FMT); ++r2) R[r2] = out + r2 * C;
    // FMT=3 sideband layout after the 3 coordinate rows (C must be a
    // multiple of 16): flag nibbles (C/8 words), qid-run boundary
    // positions (C/8 words, -1 padded), boundary qids (C/8 words) —
    // the C/8 boundary capacity tolerates query runs >= 8 records
    // (low-coverage minimap streams run ~16/query)
    uint32_t* nibw = nullptr;
    int32_t* bpos = nullptr;
    int32_t* bqid = nullptr;
    int64_t nb = 0, bcap = 0;
    int32_t last_q = -1;
    if (FMT == 3) {
        nibw = reinterpret_cast<uint32_t*>(out + 3 * C);
        bpos = out + 3 * C + C / 8;
        bqid = bpos + C / 8;
        bcap = C / 8;
        std::memset(nibw, 0, (C / 8) * 4);
    }
    while (filled < C) {
        if (FMT == 4 && st->pack_fail) break;
        if (FMT == 3 && (st->pack_fail || st->rle_fail)) break;
        if (!st->cur) {
            std::vector<int32_t> gmap;
            Chunk* ck = take_chunk(st, gmap);
            if (!ck) break;
            st->cur = ck;
            st->cur_off = 0;
            st->cur_gmap = std::move(gmap);
        }
        Chunk* ck = st->cur;
        int64_t avail = static_cast<int64_t>(ck->qid.size()) - st->cur_off;
        int64_t take = avail < C - filled ? avail : C - filled;
        const auto& gm = st->cur_gmap;
        const int64_t o = st->cur_off;
        if (FMT == 4) {
            if (static_cast<int64_t>(st->gnames.size()) >= (1LL << 28)) {
                st->pack_fail = true;
                break;
            }
            // all four coordinates must fit 16 bits: malformed lines can
            // carry qs > qe (the reference keeps them with full 32-bit
            // coordinates — the unsigned span wrap passes the filter), so
            // checking the ends alone could truncate a start coordinate
            int64_t good = 0;
            while (good < take && ck->qs[o + good] <= 65535u &&
                   ck->qe[o + good] <= 65535u &&
                   ck->ts[o + good] <= 65535u && ck->te[o + good] <= 65535u)
                ++good;
            if (good < take) {
                st->pack_fail = true;
                take = good;
            }
        }
        if (FMT == 3) {
            if (static_cast<int64_t>(st->gnames.size()) >= (1LL << 28)) {
                st->pack_fail = true;
                break;
            }
            // pre-scan: coordinates must fit 16 bits AND the piece's
            // qid-run boundary count must fit the RLE sideband
            int64_t good = 0;
            int32_t lq = last_q;
            int64_t nb2 = nb;
            while (good < take) {
                if (ck->qs[o + good] > 65535u || ck->qe[o + good] > 65535u ||
                    ck->ts[o + good] > 65535u || ck->te[o + good] > 65535u) {
                    st->pack_fail = true;
                    break;
                }
                int32_t gq = gm[ck->qid[o + good]];
                if (gq != lq) {
                    if (nb2 == bcap) {
                        st->rle_fail = true;
                        break;
                    }
                    ++nb2;
                    lq = gq;
                }
                ++good;
            }
            take = good;
        }
        if (FMT == 7) {
            // columnar: plain memcpy for coordinates, tight vectorizable
            // transforms for the id remap and flags
            std::memcpy(R[1] + filled, ck->qs.data() + o, take * 4);
            std::memcpy(R[2] + filled, ck->qe.data() + o, take * 4);
            std::memcpy(R[4] + filled, ck->ts.data() + o, take * 4);
            std::memcpy(R[5] + filled, ck->te.data() + o, take * 4);
        }
        size_t gn = st->g_qid.size();
        st->g_qid.resize(gn + take);
        st->g_tid.resize(gn + take);
        st->g_qs.resize(gn + take);
        st->g_ts.resize(gn + take);
        std::memcpy(st->g_qs.data() + gn, ck->qs.data() + o, take * 4);
        std::memcpy(st->g_ts.data() + gn, ck->ts.data() + o, take * 4);
        if (st->retain_full) {
            st->g_qe.resize(gn + take);
            st->g_te.resize(gn + take);
            st->g_ml.resize(gn + take);
            st->g_bl.resize(gn + take);
            st->g_rev.resize(gn + take);
            std::memcpy(st->g_qe.data() + gn, ck->qe.data() + o, take * 4);
            std::memcpy(st->g_te.data() + gn, ck->te.data() + o, take * 4);
            std::memcpy(st->g_ml.data() + gn, ck->ml.data() + o, take * 4);
            std::memcpy(st->g_bl.data() + gn, ck->bl.data() + o, take * 4);
            std::memcpy(st->g_rev.data() + gn, ck->rev.data() + o, take);
        }
        int64_t mirrors = 0;
        for (int64_t k = 0; k < take; ++k) {
            int32_t gq = gm[ck->qid[o + k]];
            int32_t gt = gm[ck->tid[o + k]];
            st->g_qid[gn + k] = gq;
            st->g_tid[gn + k] = gt;
            mirrors += gq != gt;
            if (FMT == 7) {
                R[0][filled + k] = gq;
                R[3][filled + k] = gt;
            } else if (FMT == 3) {
                R[0][filled + k] = gt;
                R[1][filled + k] = static_cast<int32_t>(
                    (ck->qs[o + k] << 16) | ck->qe[o + k]);
                R[2][filled + k] = static_cast<int32_t>(
                    (ck->ts[o + k] << 16) | ck->te[o + k]);
                if (gq != last_q) {
                    bpos[nb] = static_cast<int32_t>(filled + k);
                    bqid[nb] = gq;
                    ++nb;
                    last_q = gq;
                }
            } else {
                R[1][filled + k] = gt;
                R[2][filled + k] = static_cast<int32_t>(
                    (ck->qs[o + k] << 16) | ck->qe[o + k]);
                R[3][filled + k] = static_cast<int32_t>(
                    (ck->ts[o + k] << 16) | ck->te[o + k]);
            }
        }
        for (int64_t k = 0; k < take; ++k) {
            uint32_t iden_ok =
                !(static_cast<float>(ck->ml[o + k]) <
                  static_cast<float>(ck->bl[o + k]) * st->iden_f);
            uint32_t fl = 1u |
                (static_cast<uint32_t>(ck->rev[o + k]) << 1) |
                (iden_ok << 2);
            if (FMT == 7)
                R[6][filled + k] = static_cast<int32_t>(fl);
            else if (FMT == 3) {
                uint32_t idx = static_cast<uint32_t>(filled + k);
                nibw[idx >> 3] |= fl << (4 * (idx & 7));
            } else
                R[0][filled + k] = static_cast<int32_t>(
                    static_cast<uint32_t>(st->g_qid[gn + k]) | (fl << 28));
        }
        st->n_mirror += st->bi_dir ? take + mirrors : take;
        st->cur_off += take;
        filled += take;
        st->n_orig += take;
        if (st->cur_off >= static_cast<int64_t>(ck->qid.size())) {
            // keep the arena alive (global names point into it)
            st->arenas.push_back(new Arena(std::move(ck->arena)));
            delete ck;
            st->cur = nullptr;
        }
    }
    if (filled < C)
        for (int r2 = 0; r2 < (FMT == 3 ? 3 : FMT); ++r2)
            std::memset(R[r2] + filled, 0, (C - filled) * 4);
    if (FMT == 3)
        for (int64_t j = nb; j < bcap; ++j) {
            bpos[j] = -1;
            bqid[j] = 0;
        }
    return filled;
}

}  // namespace

extern "C" {

// Fill out (7, want) int32 with the next piece of globalized records
// [qid qs qe tid ts te flags]; zero-pads the tail.  Returns the number
// of real records in the piece (0 = end of stream).  `want` <= 0 falls
// back to the chunk_recs passed at begin.
int64_t ma_mt_next(MtState* st, int32_t* out, int64_t want) {
    return mt_next_impl<7>(st, out, want);
}

// 4-row packed variant: [qid|flags<<28, tid, qs<<16|qe, ts<<16|te].
// Returns the filled count; when ma_mt_pack_failed() reports 1 after a
// call, the stream has a record that cannot pack — the caller must
// switch to ma_mt_next for the remainder (this call's piece is valid).
int64_t ma_mt_next4(MtState* st, int32_t* out, int64_t want) {
    return mt_next_impl<4>(st, out, want);
}

// Flat 13.5 B/record variant (want must be a multiple of 16): 3
// coordinate rows [tid, qs<<16|qe, ts<<16|te] + flag nibbles + a qid
// run-length sideband (PAF streams are query-grouped, so qid is
// piecewise constant; minimap2 emits ~16-90 records per query).  Total
// words per piece: 3*want + 3*want/8, decoded on the device (decode3,
// csrc/loader.cu) into the 4-row layout.  On a
// coordinate/id overflow ma_mt_pack_failed() is set (switch to 7-row);
// on a boundary-count overflow ma_mt_rle_failed() is set (switch to
// 4-row); either way this call's filled prefix is valid.
int64_t ma_mt_next3(MtState* st, int32_t* out, int64_t want) {
    return mt_next_impl<3>(st, out, want);
}

int ma_mt_pack_failed(MtState* st) { return st->pack_fail ? 1 : 0; }
int ma_mt_rle_failed(MtState* st) { return st->rle_fail ? 1 : 0; }

void ma_mt_info(MtState* st, MaMtInfo* info) {
    int64_t nb = 0;
    for (size_t i = 0; i < st->gnames.size(); ++i)
        nb += st->gname_len[i] + 1;
    info->n_orig = st->n_orig;
    info->n_mirror = st->n_mirror;
    info->n_seq = static_cast<int64_t>(st->gnames.size());
    info->n_lines = st->n_lines;
    info->max_len = st->max_len;
    info->names_bytes = nb;
}

void ma_mt_names(MtState* st, char* out) {
    int64_t off = 0;
    for (size_t i = 0; i < st->gnames.size(); ++i) {
        std::memcpy(out + off, st->gnames[i], st->gname_len[i]);
        off += st->gname_len[i];
        out[off++] = 0;
    }
}

void ma_mt_seq_len(MtState* st, uint32_t* out) {
    std::memcpy(out, st->gseq_len.data(), st->gseq_len.size() * 4);
}

// Exact ksort radix permutation of the implied mirrored array
// (hit.c:92-100): rank[(orig<<1)|is_mirror] = sorted position; -1 when
// the side is absent.  CPU-bound; call while the device kernel runs.
void ma_mt_rank(MtState* st) {
    if (st->rank) return;
    int64_t n = st->n_orig;
    std::vector<uint64_t> keys;
    std::vector<int64_t> src;
    keys.reserve(st->n_mirror);
    src.reserve(st->n_mirror);
    for (int64_t i = 0; i < n; ++i) {
        keys.push_back(static_cast<uint64_t>(st->g_qid[i]) << 32 |
                       st->g_qs[i]);
        src.push_back(i << 1);
        if (st->bi_dir && st->g_qid[i] != st->g_tid[i]) {
            keys.push_back(static_cast<uint64_t>(st->g_tid[i]) << 32 |
                           st->g_ts[i]);
            src.push_back((i << 1) | 1);
        }
    }
    int64_t m = static_cast<int64_t>(keys.size());
    ma_radix_argsort_u64(keys.data(), src.data(), m);
    st->rank = static_cast<int64_t*>(std::malloc(2 * n * 8 + 8));
    for (int64_t k = 0; k < 2 * n; ++k) st->rank[k] = -1;
    for (int64_t p = 0; p < m; ++p) st->rank[src[p]] = p;
}

void ma_mt_rank_fetch(MtState* st, const int64_t* idx, int64_t n_idx,
                      int64_t cap, int64_t* out) {
    // idx: kernel arc indices (j for q-side, cap+j for mirrors)
    for (int64_t k = 0; k < n_idx; ++k) {
        int64_t j = idx[k];
        int64_t side = j >= cap ? 1 : 0;
        j -= side * cap;
        out[k] = st->rank[(j << 1) | side];
    }
}

// retain qe/te/ml/bl/rev alongside the rank columns (-p paf replay);
// must be called between ma_mt_begin and the first ma_mt_next*
void ma_mt_retain_full(MtState* st) { st->retain_full = true; }

}  // extern "C" (reopened below)

namespace {

// scalar ma_hit2arc classification CODE (semantics of miniasm.h:86-104,
// mirroring the vectorized core/hit2arc.py; only the code matters to the
// ma_hit_flt keep test, hit.c:195-216): -1 internal, -2 qcont, -3 tcont,
// -4 short, 0 proper overlap.
int hit2arc_code(int64_t qs, int64_t qe, int64_t ts, int64_t te, int rev,
                 int64_t ql, int64_t tl, int64_t max_hang, float int_frac,
                 int64_t min_ovlp) {
    int64_t tl5 = rev ? tl - te : ts;
    int64_t tl3 = rev ? ts : tl - te;
    int64_t qh5 = qs, qh3 = ql - qe;
    int64_t ext5 = qh5 < tl5 ? qh5 : tl5;
    int64_t ext3 = qh3 < tl3 ? qh3 : tl3;
    int64_t span = qe - qs;
    if (ext5 > max_hang || ext3 > max_hang ||
        static_cast<float>(span) <
            static_cast<float>(span + ext5 + ext3) * int_frac)
        return -1;
    if (qh5 <= tl5 && qh3 <= tl3) return -2;
    if (qh5 >= tl5 && qh3 >= tl3) return -3;
    if (span + ext5 + ext3 < min_ovlp || (te - ts) + ext5 + ext3 < min_ovlp)
        return -4;
    return 0;
}

// ma_hit_cut coordinate rewrite + keep test (hit.c:162-193; scalar twin
// of select/fused2._cut_pass including the unsigned e-side min quirk).
bool cut_replay(int32_t rs, int32_t re, bool rdel, int32_t ts_, int32_t tse,
                bool tdel, int rev, int64_t min_span, uint32_t& qs,
                uint32_t& qe, uint32_t& ts, uint32_t& te) {
    if (rdel || tdel) return false;
    int64_t qs0 = qs, qe0 = qe, ts0 = ts, te0 = te;
    int64_t rq_s = rs, rq_e = re, rt_s = ts_, rt_e = tse;
    int64_t qs1, qe1, ts1, te1;
    if (rev) {
        qs1 = te0 < rt_e ? qs0 : qs0 + (te0 - rt_e);
        qe1 = ts0 > rt_s ? qe0 : qe0 - (rt_s - ts0);
        ts1 = qe0 < rq_e ? ts0 : ts0 + (qe0 - rq_e);
        te1 = qs0 > rq_s ? te0 : te0 - (rq_s - qs0);
    } else {
        qs1 = ts0 > rt_s ? qs0 : qs0 + (rt_s - ts0);
        qe1 = te0 < rt_e ? qe0 : qe0 - (te0 - rt_e);
        ts1 = qs0 > rq_s ? ts0 : ts0 + (rq_s - qs0);
        te1 = qe0 < rq_e ? te0 : te0 - (qe0 - rq_e);
    }
    uint32_t qs2 = static_cast<uint32_t>((qs1 > rq_s ? qs1 : rq_s) - rq_s);
    uint32_t ts2 = static_cast<uint32_t>((ts1 > rt_s ? ts1 : rt_s) - rt_s);
    uint32_t ue = static_cast<uint32_t>(qe1);
    uint32_t qe2 = (ue < static_cast<uint32_t>(rq_e)
                        ? ue : static_cast<uint32_t>(rq_e))
                   - static_cast<uint32_t>(rq_s);
    ue = static_cast<uint32_t>(te1);
    uint32_t te2 = (ue < static_cast<uint32_t>(rt_e)
                        ? ue : static_cast<uint32_t>(rt_e))
                   - static_cast<uint32_t>(rt_s);
    qs = qs2, qe = qe2, ts = ts2, te = te2;
    return static_cast<int32_t>(qe2 - qs2) >= min_span &&
           static_cast<int32_t>(te2 - ts2) >= min_span;
}

struct PafOut {
    int fd;
    std::vector<char> buf;
    size_t w = 0;
    bool err = false;
    explicit PafOut(int f) : fd(f), buf(1 << 22) {}
    void flush() {
        size_t off = 0;
        while (off < w) {
            ssize_t r = ::write(fd, buf.data() + off, w - off);
            if (r < 0 && errno == EINTR) continue;
            if (r <= 0) {
                // surface the failure (ENOSPC/EPIPE/...): a silently
                // truncated -p paf must not report success
                err = true;
                break;
            }
            off += static_cast<size_t>(r);
        }
        w = 0;
    }
    inline void need(size_t n) {
        if (w + n > buf.size()) flush();
    }
    inline void put_str(const char* s, size_t n) {
        std::memcpy(buf.data() + w, s, n);
        w += n;
    }
    inline void put_i(int64_t v) {
        auto r = std::to_chars(buf.data() + w, buf.data() + buf.size(), v);
        w = static_cast<size_t>(r.ptr - buf.data());
    }
    inline void put_c(char c) { buf[w++] = c; }
};

}  // namespace

extern "C" {

// -p paf fast path (print_hits, main.c:21-30): replay the two cut passes
// + the relaxed-parameter filter over the retained records in the exact
// ksort-sorted mirrored order, printing survivors whose reads outlive
// containment removal.  Tables come from the device select kernel
// (per-read, O(n_seq) fetch instead of an O(hits) coordinate download).
// Requires ma_mt_retain_full before the stream was consumed.
int64_t ma_mt_print_paf(MtState* st, const int32_t* s1, const int32_t* e1,
                        const uint8_t* d1, const int32_t* s2,
                        const int32_t* e2, const uint8_t* d2,
                        const uint8_t* alive, int64_t min_span,
                        int64_t max_hang_flt, int64_t min_ovlp_flt,
                        int fd) {
    int64_t n = st->n_orig;
    std::vector<uint64_t> keys;
    std::vector<int64_t> src;
    keys.reserve(st->n_mirror);
    src.reserve(st->n_mirror);
    for (int64_t i = 0; i < n; ++i) {
        keys.push_back(static_cast<uint64_t>(st->g_qid[i]) << 32 |
                       st->g_qs[i]);
        src.push_back(i << 1);
        if (st->bi_dir && st->g_qid[i] != st->g_tid[i]) {
            keys.push_back(static_cast<uint64_t>(st->g_tid[i]) << 32 |
                           st->g_ts[i]);
            src.push_back((i << 1) | 1);
        }
    }
    int64_t m = static_cast<int64_t>(keys.size());
    ma_radix_argsort_u64(keys.data(), src.data(), m);

    PafOut out(fd);
    int64_t printed = 0;
    for (int64_t p = 0; p < m; ++p) {
        int64_t j = src[p] >> 1;
        int side = static_cast<int>(src[p] & 1);
        int32_t q, t;
        uint32_t qs, qe, ts, te;
        if (!side) {
            q = st->g_qid[j], t = st->g_tid[j];
            qs = st->g_qs[j], qe = st->g_qe[j];
            ts = st->g_ts[j], te = st->g_te[j];
        } else {  // implied mirror (hit.c:92-98: plain q/t swap)
            q = st->g_tid[j], t = st->g_qid[j];
            qs = st->g_ts[j], qe = st->g_te[j];
            ts = st->g_qs[j], te = st->g_qe[j];
        }
        int rev = st->g_rev[j];
        if (!cut_replay(s1[q], e1[q], d1[q], s1[t], e1[t], d1[t], rev,
                        min_span, qs, qe, ts, te))
            continue;
        int code = hit2arc_code(qs, qe, ts, te, rev,
                                e1[q] - s1[q], e1[t] - s1[t],
                                max_hang_flt, 0.5f, min_ovlp_flt);
        if (code == -1 || code == -4) continue;
        if (!cut_replay(s2[q], e2[q], d2[q], s2[t], e2[t], d2[t], rev,
                        min_span, qs, qe, ts, te))
            continue;
        if (!alive[q] || !alive[t]) continue;
        // merged sub frame for the header columns (ma_sub_merge)
        int64_t mqs = static_cast<int64_t>(s1[q]) + s2[q];
        int64_t mqe = static_cast<int64_t>(s1[q]) + e2[q];
        int64_t mts = static_cast<int64_t>(s1[t]) + s2[t];
        int64_t mte = static_cast<int64_t>(s1[t]) + e2[t];
        out.need(512 + st->gname_len[q] + st->gname_len[t]);
        out.put_str(st->gnames[q], st->gname_len[q]);
        out.put_c(':');
        out.put_i(mqs + 1);
        out.put_c('-');
        out.put_i(mqe);
        out.put_c('\t');
        out.put_i(mqe - mqs);
        out.put_c('\t');
        out.put_i(qs);
        out.put_c('\t');
        out.put_i(qe);
        out.put_c('\t');
        out.put_c(rev ? '-' : '+');
        out.put_c('\t');
        out.put_str(st->gnames[t], st->gname_len[t]);
        out.put_c(':');
        out.put_i(mts + 1);
        out.put_c('-');
        out.put_i(mte);
        out.put_c('\t');
        out.put_i(mte - mts);
        out.put_c('\t');
        out.put_i(ts);
        out.put_c('\t');
        out.put_i(te);
        out.put_c('\t');
        out.put_i(st->g_ml[j]);
        out.put_c('\t');
        out.put_i(st->g_bl[j]);
        out.put_str("\t255\n", 5);
        ++printed;
    }
    out.flush();
    return out.err ? -1 : printed;  // -1: a write failed (truncated output)
}

void ma_mt_join(MtState* st) {
    {
        std::lock_guard<std::mutex> lk(st->bmx);
        st->aborted = true;
    }
    {
        std::lock_guard<std::mutex> lk(st->cmx);
        st->abort_flag = true;
    }
    st->bcv_push.notify_all();
    st->bcv_pop.notify_all();
    st->ccv.notify_all();
    for (auto& t : st->threads)
        if (t.joinable()) t.join();
    st->threads.clear();
}

void ma_mt_free(MtState* st) {
    if (!st) return;
    ma_mt_join(st);
    delete st;
}

}  // extern "C"
