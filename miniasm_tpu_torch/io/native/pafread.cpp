// Native PAF loader: gzip-capable streaming tokenizer + record filter +
// name interning, one pass, producing SoA columns ready for device upload.
//
// Replaces the reference's scalar hot loop (paf.c:34-67 parsing,
// hit.c:82-99 filter+intern) with the same observable semantics:
//   - first 11 tab fields parsed (qn ql qs qe strand tn tl ts te ml bl);
//     lines with <10 separators skipped; an exactly-10-field line reuses
//     the previous record's bl (the reference reuses the caller's struct);
//   - filter qe-qs < min_span || te-ts < min_span || ml < min_match BEFORE
//     interning (id order = first appearance on surviving lines, qn first);
//   - optional name exclusion set (for -R).

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Arena {
    std::vector<char*> blocks;
    size_t used = 0, cap = 0;

    const char* intern(const char* s, size_t len) {
        if (used + len + 1 > cap) {
            cap = 1 << 22;
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

}  // namespace

extern "C" {

struct MaPafLoad {
    int64_t n_rec, n_seq, n_lines, names_bytes;
    int32_t* qid;
    uint32_t* qs;
    uint32_t* qe;
    int32_t* tid;
    uint32_t* ts;
    uint32_t* te;
    uint32_t* ml;
    uint32_t* bl;
    uint8_t* rev;
    uint32_t* seq_len;
    char* names;  // NUL-separated, id order
};

MaPafLoad* ma_paf_load(const char* fn, int64_t min_span, int64_t min_match,
                       const char* excl_names, int64_t excl_bytes) {
    gzFile fp = (fn && std::strcmp(fn, "-") != 0) ? gzopen(fn, "r")
                                                  : gzdopen(0, "r");
    if (!fp) return nullptr;
    gzbuffer(fp, 1 << 20);

    std::unordered_set<std::string> excl;
    for (int64_t off = 0; off < excl_bytes;) {
        size_t len = std::strlen(excl_names + off);
        excl.emplace(excl_names + off, len);
        off += static_cast<int64_t>(len) + 1;
    }

    Arena arena;
    std::unordered_map<std::string_view, int32_t> dict;
    std::vector<const char*> names;
    std::vector<uint32_t> seq_len;
    auto put = [&](const char* s, size_t len, uint32_t l) -> int32_t {
        auto it = dict.find(std::string_view(s, len));
        if (it != dict.end()) return it->second;
        const char* stable = arena.intern(s, len);
        int32_t id = static_cast<int32_t>(names.size());
        dict.emplace(std::string_view(stable, len), id);
        names.push_back(stable);
        seq_len.push_back(l);
        return id;
    };

    std::vector<int32_t> c_qid, c_tid;
    std::vector<uint32_t> c_qs, c_qe, c_ts, c_te, c_ml, c_bl;
    std::vector<uint8_t> c_rev;

    std::string line;
    line.reserve(1 << 12);
    std::vector<char> buf(1 << 20);
    int64_t n_lines = 0;
    uint32_t last_bl = 0;
    int nread;
    std::string pending;
    bool done = false;
    while (!done) {
        nread = gzread(fp, buf.data(), static_cast<unsigned>(buf.size()));
        if (nread <= 0) done = true;
        const char* base = buf.data();
        int64_t len = nread > 0 ? nread : 0;
        int64_t pos = 0;
        while (true) {
            const char* nl = static_cast<const char*>(
                std::memchr(base + pos, '\n', len - pos));
            const char* lb;
            size_t ll;
            std::string tmp;
            if (nl == nullptr) {
                if (!done) {
                    pending.append(base + pos, len - pos);
                    break;
                }
                if (pos >= len && pending.empty()) break;
                tmp = pending;
                tmp.append(base + pos, len - pos);
                pending.clear();
                lb = tmp.data();
                ll = tmp.size();
                if (ll == 0) break;
            } else if (!pending.empty()) {
                tmp = pending;
                tmp.append(base + pos, nl - (base + pos));
                pending.clear();
                lb = tmp.data();
                ll = tmp.size();
            } else {
                lb = base + pos;
                ll = nl - (base + pos);
            }

            // --- tokenize first 11 fields ---
            const char* f[11];
            size_t flen[11];
            int t = 0;
            const char* p = lb;
            const char* end = lb + ll;
            while (t < 11 && p <= end) {
                const char* tab = static_cast<const char*>(
                    std::memchr(p, '\t', end - p));
                const char* fe = tab ? tab : end;
                f[t] = p;
                flen[t] = fe - p;
                ++t;
                if (!tab) break;
                p = tab + 1;
            }
            // count remaining separators to know the total field count
            int total_fields = t;
            if (t == 11 && p <= end) {
                // already have 11; more fields may follow but don't matter
                total_fields = 11;
            }
            if (total_fields >= 10) {
                ++n_lines;
                auto u32 = [](const char* s, size_t n2) -> uint32_t {
                    uint32_t v = 0;
                    for (size_t i = 0; i < n2; ++i) {
                        char c = s[i];
                        if (c < '0' || c > '9') break;
                        v = v * 10 + (c - '0');
                    }
                    return v;
                };
                uint32_t ql = u32(f[1], flen[1]), qsv = u32(f[2], flen[2]),
                         qev = u32(f[3], flen[3]);
                uint32_t tl = u32(f[6], flen[6]), tsv = u32(f[7], flen[7]),
                         tev = u32(f[8], flen[8]);
                uint32_t mlv = u32(f[9], flen[9]);
                uint32_t blv = total_fields > 10 ? u32(f[10], flen[10]) : last_bl;
                last_bl = blv;
                uint8_t rev = flen[4] > 0 && f[4][0] == '-';
                if (!(qev - qsv < static_cast<uint32_t>(min_span) ||
                      tev - tsv < static_cast<uint32_t>(min_span) ||
                      mlv < static_cast<uint32_t>(min_match))) {
                    bool drop = false;
                    if (!excl.empty()) {
                        drop = excl.count(std::string(f[0], flen[0])) ||
                               excl.count(std::string(f[5], flen[5]));
                    }
                    if (!drop) {
                        c_qid.push_back(put(f[0], flen[0], ql));
                        c_qs.push_back(qsv);
                        c_qe.push_back(qev);
                        c_tid.push_back(put(f[5], flen[5], tl));
                        c_ts.push_back(tsv);
                        c_te.push_back(tev);
                        c_ml.push_back(mlv);
                        c_bl.push_back(blv);
                        c_rev.push_back(rev);
                    }
                }
            }
            if (nl == nullptr) break;
            pos = (nl - base) + 1;
            if (pos >= len) break;
        }
    }
    gzclose(fp);

    auto* out = new MaPafLoad();
    out->n_rec = static_cast<int64_t>(c_qid.size());
    out->n_seq = static_cast<int64_t>(names.size());
    out->n_lines = n_lines;
    auto dup = [](auto& v) {
        using T = typename std::remove_reference_t<decltype(v)>::value_type;
        T* p2 = static_cast<T*>(std::malloc(v.size() * sizeof(T) + 1));
        std::memcpy(p2, v.data(), v.size() * sizeof(T));
        return p2;
    };
    out->qid = dup(c_qid);
    out->qs = dup(c_qs);
    out->qe = dup(c_qe);
    out->tid = dup(c_tid);
    out->ts = dup(c_ts);
    out->te = dup(c_te);
    out->ml = dup(c_ml);
    out->bl = dup(c_bl);
    out->rev = dup(c_rev);
    out->seq_len = dup(seq_len);
    int64_t nb = 0;
    for (const char* s : names) nb += static_cast<int64_t>(std::strlen(s)) + 1;
    out->names = static_cast<char*>(std::malloc(nb ? nb : 1));
    out->names_bytes = nb;
    int64_t off = 0;
    for (const char* s : names) {
        size_t l2 = std::strlen(s) + 1;
        std::memcpy(out->names + off, s, l2);
        off += static_cast<int64_t>(l2);
    }
    return out;
}

void ma_paf_free(MaPafLoad* p) {
    if (!p) return;
    std::free(p->qid);
    std::free(p->qs);
    std::free(p->qe);
    std::free(p->tid);
    std::free(p->ts);
    std::free(p->te);
    std::free(p->ml);
    std::free(p->bl);
    std::free(p->rev);
    std::free(p->seq_len);
    std::free(p->names);
    delete p;
}

}  // extern "C"

extern "C" void ma_radix_argsort_u64(uint64_t*, int64_t*, int64_t);

extern "C" {

// ---- v2 loader: ORIGINALS ONLY, in parse order.  The device select kernel
// (select/fused2.py) processes each original hit together with its implied
// mirror (reference hit.c:92-98) as a dual-sided row — no mirrored array is
// ever materialized or uploaded.  The reference's exact radix order of the
// mirrored hit array (ksort.h tie permutation, needed downstream for the
// byte-identical arc insertion order of ma_sg_gen, asm.c:20-36) is captured
// host-side as a rank table: rank[(orig<<1)|is_mirror] = position the row
// would have had in the sorted mirrored array.  The host applies it to the
// handful of surviving arcs after the device kernel returns.  The colmat
// holds exactly the n_orig originals: the port's tables are sized exactly,
// so no column is padded.

struct MaHits3 {
    int64_t n_orig, n_mirror, n_seq, n_lines, names_bytes, max_len;
    int32_t* colmat;   // (7, n_orig) [qid qs qe tid ts te flags], parse order
    int64_t* rank;     // (2*n_orig): rank[(j<<1)|side], -1 when side absent
    uint32_t* seq_len;
    char* names;
    void* raw;         // MaPafLoad kept alive until ranks are built
    int64_t bi_dir;
};

MaHits3* ma_paf_load_hits3(const char* fn, int64_t min_span, int64_t min_match,
                           const char* excl_names, int64_t excl_bytes,
                           int bi_dir, double min_iden) {
    MaPafLoad* raw = ma_paf_load(fn, min_span, min_match, excl_names, excl_bytes);
    if (!raw) return nullptr;
    int64_t n = raw->n_rec;

    auto* out = new MaHits3();
    out->n_orig = n;
    out->n_seq = raw->n_seq;
    out->n_lines = raw->n_lines;
    out->colmat = static_cast<int32_t*>(std::malloc(7 * n * 4 + 4));
    out->rank = nullptr;
    out->bi_dir = bi_dir;
    int32_t* C = out->colmat;
    float iden_f = static_cast<float>(min_iden);
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t iden_ok = !(static_cast<float>(raw->ml[i]) <
                             static_cast<float>(raw->bl[i]) * iden_f);
        C[0 * n + i] = raw->qid[i];
        C[1 * n + i] = static_cast<int32_t>(raw->qs[i]);
        C[2 * n + i] = static_cast<int32_t>(raw->qe[i]);
        C[3 * n + i] = raw->tid[i];
        C[4 * n + i] = static_cast<int32_t>(raw->ts[i]);
        C[5 * n + i] = static_cast<int32_t>(raw->te[i]);
        C[6 * n + i] = static_cast<int32_t>(
            1u | (static_cast<uint32_t>(raw->rev[i]) << 1) | (iden_ok << 2));
        m += (bi_dir && raw->qid[i] != raw->tid[i]) ? 2 : 1;
    }
    out->n_mirror = m;
    uint32_t max_len = 0;
    for (int64_t i = 0; i < raw->n_seq; ++i)
        if (raw->seq_len[i] > max_len) max_len = raw->seq_len[i];
    out->max_len = max_len;
    out->seq_len = raw->seq_len;
    raw->seq_len = nullptr;
    out->names = raw->names;
    out->names_bytes = raw->names_bytes;
    raw->names = nullptr;
    out->raw = raw;
    return out;
}

// phase 2 (CPU-bound; run while the device chews on the uploaded columns):
// reproduce the reference's mirrored key sequence + exact radix argsort and
// invert it into the rank table.
void ma_hits3_rank(MaHits3* h) {
    if (h->rank) return;
    auto* raw = static_cast<MaPafLoad*>(h->raw);
    int64_t n = h->n_orig;
    std::vector<uint64_t> keys;
    std::vector<int64_t> src;
    keys.reserve(h->n_mirror);
    src.reserve(h->n_mirror);
    for (int64_t i = 0; i < n; ++i) {
        keys.push_back(static_cast<uint64_t>(raw->qid[i]) << 32 | raw->qs[i]);
        src.push_back(i << 1);
        if (h->bi_dir && raw->qid[i] != raw->tid[i]) {
            keys.push_back(static_cast<uint64_t>(raw->tid[i]) << 32 | raw->ts[i]);
            src.push_back((i << 1) | 1);
        }
    }
    int64_t m = static_cast<int64_t>(keys.size());
    ma_radix_argsort_u64(keys.data(), src.data(), m);
    h->rank = static_cast<int64_t*>(std::malloc(2 * n * 8 + 8));
    for (int64_t k = 0; k < 2 * n; ++k) h->rank[k] = -1;
    for (int64_t p = 0; p < m; ++p) h->rank[src[p]] = p;
    ma_paf_free(raw);
    h->raw = nullptr;
}

void ma_hits3_free(MaHits3* h) {
    if (!h) return;
    if (h->raw) ma_paf_free(static_cast<MaPafLoad*>(h->raw));
    std::free(h->colmat);
    std::free(h->rank);
    std::free(h->seq_len);
    std::free(h->names);
    delete h;
}

}  // extern "C"
