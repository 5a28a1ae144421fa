// Native FASTA/FASTQ streaming + unitig sequence splicing + the -R
// contained-read prefilter.
//
// The reader reproduces kseq.h record semantics (reference kseq.h:193-239):
// a record starts at '>' or '@'; the name is the header up to the first
// whitespace; sequence lines are concatenated until the next record or the
// FASTQ '+' separator; quality lines are skipped until their accumulated
// length reaches the sequence length.
//
// ma_ug_seq_native implements the splice of reference asm.c:236-290: each
// read contributes its trimmed prefix (forward) or the complement of its
// reversed trimmed sequence (reverse) into its unitig buffer at the golden-
// path offset; unfilled bases stay 'N'.
//
// ma_no_cont implements reference hit.c:38-68 (-R Step 0): one PAF pass
// recording clearly-contained reads (id order = first containment
// appearance); comparisons use float32 like the reference's int_frac.

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// buffered gzip byte stream
struct GzStream {
    gzFile fp = nullptr;
    std::vector<char> buf;
    int64_t pos = 0, len = 0;
    bool eof = false;

    bool open(const char* fn) {
        fp = (fn && std::strcmp(fn, "-") != 0) ? gzopen(fn, "r")
                                               : gzdopen(0, "r");
        if (!fp) return false;
        gzbuffer(fp, 1 << 20);
        buf.resize(1 << 20);
        return true;
    }
    int peek() {
        if (pos >= len) {
            if (eof) return -1;
            int n = gzread(fp, buf.data(), static_cast<unsigned>(buf.size()));
            if (n <= 0) {
                eof = true;
                return -1;
            }
            len = n;
            pos = 0;
        }
        return static_cast<unsigned char>(buf[pos]);
    }
    int getc_() {
        int c = peek();
        if (c >= 0) ++pos;
        return c;
    }
    // append bytes up to (excluding) the next newline into out; consume the
    // newline; returns false at EOF with nothing read
    bool getline_(std::string& out) {
        out.clear();
        if (peek() < 0) return false;
        while (true) {
            if (pos >= len) {
                if (peek() < 0) return true;  // EOF terminates the line
            }
            const char* base = buf.data() + pos;
            const char* nl = static_cast<const char*>(
                std::memchr(base, '\n', len - pos));
            if (nl) {
                out.append(base, nl - base);
                pos += (nl - base) + 1;
                return true;
            }
            out.append(base, len - pos);
            pos = len;
        }
    }
    void close() {
        if (fp) gzclose(fp);
        fp = nullptr;
    }
};

// kseq-style FASTA/FASTQ record iterator
struct FastxReader {
    GzStream gz;
    std::string line;
    bool primed = false;  // line holds the next header

    bool open(const char* fn) { return gz.open(fn); }

    // fills (name, seq); returns false at EOF
    bool next(std::string& name, std::string& seq) {
        if (!primed) {
            while (gz.getline_(line)) {
                if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
                    primed = true;
                    break;
                }
            }
            if (!primed) return false;
        }
        size_t sp = line.find_first_of(" \t", 1);
        name.assign(line, 1, (sp == std::string::npos ? line.size() : sp) - 1);
        seq.clear();
        primed = false;
        while (gz.getline_(line)) {
            if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
                primed = true;
                break;
            }
            if (!line.empty() && line[0] == '+') {
                // kseq.h semantics: '+' always enters quality-skipping
                // mode (even for '>' records) and consumes lines until
                // the accumulated quality covers the sequence
                size_t qlen = 0;
                while (qlen < seq.size() && gz.getline_(line))
                    qlen += line.size();
                break;
            }
            seq += line;
        }
        return true;
    }
    void close() { gz.close(); }
};

// complement table with the reference's quirks (asm.c:225-233): IUPAC
// complement both cases, U->A, '`'(96) -> '@'(64), bytes >= 128 -> 'N'
struct CompTab {
    unsigned char t[256];
    CompTab() {
        for (int i = 0; i < 256; ++i) t[i] = static_cast<unsigned char>(i);
        const char* a = "ABCDGHKMRTUVY";
        const char* b = "TVGHCDMKYAABR";
        for (int i = 0; a[i]; ++i) {
            t[static_cast<int>(a[i])] = b[i];
            t[a[i] + 32] = b[i] + 32;
        }
        t['`'] = '@';
        for (int i = 128; i < 256; ++i) t[i] = 'N';
    }
};
const CompTab comp_tab;

}  // namespace

extern "C" {

struct MaUgSeqOut {
    int64_t total_len;
    int64_t n_utg;
    int64_t* offsets;  // n_utg+1
    char* seq;         // concatenated unitig sequences
};

MaUgSeqOut* ma_ug_seq_native(
    const char* fn, int64_t n_reads, const char* names_blob,
    int64_t names_bytes, int has_sub, const uint32_t* sub_s,
    const uint32_t* sub_e, const int64_t* t_utg, const uint8_t* t_ori,
    const uint32_t* t_start, const uint32_t* t_len, int64_t n_utg,
    const uint32_t* utg_len) {
    FastxReader rd;
    if (!rd.open(fn)) return nullptr;

    std::unordered_map<std::string_view, int64_t> dict;
    dict.reserve(static_cast<size_t>(n_reads) * 2);
    {
        int64_t off = 0;
        for (int64_t i = 0; i < n_reads && off < names_bytes; ++i) {
            size_t l = std::strlen(names_blob + off);
            dict.emplace(std::string_view(names_blob + off, l), i);
            off += static_cast<int64_t>(l) + 1;
        }
    }

    auto* out = new MaUgSeqOut();
    out->n_utg = n_utg;
    out->offsets = static_cast<int64_t*>(std::malloc((n_utg + 1) * 8 + 8));
    int64_t tot = 0;
    for (int64_t i = 0; i < n_utg; ++i) {
        out->offsets[i] = tot;
        tot += utg_len[i];
    }
    out->offsets[n_utg] = tot;
    out->total_len = tot;
    out->seq = static_cast<char*>(std::malloc(tot + 1));
    std::memset(out->seq, 'N', tot);

    std::string name, seq;
    while (rd.next(name, seq)) {
        auto it = dict.find(std::string_view(name));
        if (it == dict.end()) continue;
        int64_t id = it->second;
        if (t_len[id] == 0) continue;
        const char* s = seq.data();
        size_t sl = seq.size();
        if (has_sub) {
            // trim to the selected sub-interval (asm.c:270-274); the
            // reference asserts the interval fits the record — skip
            // malformed records instead of reading out of bounds
            if (static_cast<size_t>(sub_e[id] - sub_s[id]) > sl ||
                sub_e[id] < sub_s[id])
                continue;
            s += sub_s[id];
            sl = sub_e[id] - sub_s[id];
        }
        char* dst = out->seq + out->offsets[t_utg[id]] + t_start[id];
        uint32_t L = t_len[id];
        if (L > sl) continue;  // malformed input; reference would assert
        if (!t_ori[id]) {
            std::memcpy(dst, s, L);
        } else {
            for (uint32_t i = 0; i < L; ++i)
                dst[i] = comp_tab.t[static_cast<unsigned char>(s[sl - 1 - i])];
        }
    }
    rd.close();
    return out;
}

void ma_ug_seq_free(MaUgSeqOut* p) {
    if (!p) return;
    std::free(p->offsets);
    std::free(p->seq);
    delete p;
}

struct MaNoCont {
    int64_t n;
    int64_t names_bytes;
    char* names;      // NUL-separated, first-containment order
    uint32_t* lens;
};

MaNoCont* ma_no_cont(const char* fn, int64_t min_span, int64_t min_match,
                     int64_t max_hang, double int_frac) {
    GzStream gz;
    if (!gz.open(fn)) return nullptr;

    std::unordered_map<std::string, uint32_t> dict;
    std::vector<const std::string*> order;
    std::vector<uint32_t> lens;
    float frac = static_cast<float>(int_frac);

    std::string line;
    std::string fld[11];
    while (gz.getline_(line)) {
        // split first 11 tab fields (paf.c:34-56); <10 separators -> skip
        int nf = 0;
        size_t start = 0;
        for (size_t i = 0; i <= line.size() && nf < 11; ++i) {
            if (i == line.size() || line[i] == '\t') {
                fld[nf++].assign(line, start, i - start);
                start = i + 1;
                if (i == line.size()) break;
            }
        }
        if (nf < 10) continue;
        uint32_t ql = static_cast<uint32_t>(std::strtoul(fld[1].c_str(), nullptr, 10));
        uint32_t qs = static_cast<uint32_t>(std::strtoul(fld[2].c_str(), nullptr, 10));
        uint32_t qe = static_cast<uint32_t>(std::strtoul(fld[3].c_str(), nullptr, 10));
        int rev = fld[4] == "-";
        uint32_t tl = static_cast<uint32_t>(std::strtoul(fld[6].c_str(), nullptr, 10));
        uint32_t ts = static_cast<uint32_t>(std::strtoul(fld[7].c_str(), nullptr, 10));
        uint32_t te = static_cast<uint32_t>(std::strtoul(fld[8].c_str(), nullptr, 10));
        uint32_t ml = static_cast<uint32_t>(std::strtoul(fld[9].c_str(), nullptr, 10));
        if (qe - qs < static_cast<uint32_t>(min_span) ||
            te - ts < static_cast<uint32_t>(min_span) ||
            ml < static_cast<uint32_t>(min_match))
            continue;
        // hit.c:52-63, all int arithmetic with the same promotions
        int l5 = rev ? static_cast<int>(tl - te) : static_cast<int>(ts);
        int l3 = rev ? static_cast<int>(ts) : static_cast<int>(tl - te);
        auto put = [&](const std::string& nm, uint32_t l) {
            auto it = dict.find(nm);
            if (it != dict.end()) return;
            auto r = dict.emplace(nm, static_cast<uint32_t>(order.size()));
            order.push_back(&r.first->first);
            lens.push_back(l);
        };
        if ((ql >> 1) > tl) {
            if (l5 > static_cast<int>(max_hang >> 2) ||
                l3 > static_cast<int>(max_hang >> 2) ||
                static_cast<float>(te - ts) < static_cast<float>(tl) * frac)
                continue;  // internal match
            if (static_cast<int>(qs) - l5 > static_cast<int>(max_hang << 1) &&
                static_cast<int>(ql - qe) - l3 > static_cast<int>(max_hang << 1))
                put(fld[5], tl);
        } else if (ql < (tl >> 1)) {
            if (qs > static_cast<uint32_t>(max_hang >> 2) ||
                ql - qe > static_cast<uint32_t>(max_hang >> 2) ||
                static_cast<float>(qe - qs) < static_cast<float>(ql) * frac)
                continue;  // internal
            if (l5 - static_cast<int>(qs) > static_cast<int>(max_hang << 1) &&
                l3 - static_cast<int>(ql - qe) > static_cast<int>(max_hang << 1))
                put(fld[0], ql);
        }
    }
    gz.close();

    auto* out = new MaNoCont();
    out->n = static_cast<int64_t>(order.size());
    int64_t bytes = 0;
    for (auto* s : order) bytes += static_cast<int64_t>(s->size()) + 1;
    out->names_bytes = bytes;
    out->names = static_cast<char*>(std::malloc(bytes + 1));
    char* p = out->names;
    for (auto* s : order) {
        std::memcpy(p, s->c_str(), s->size() + 1);
        p += s->size() + 1;
    }
    out->lens = static_cast<uint32_t*>(std::malloc(out->n * 4 + 4));
    std::memcpy(out->lens, lens.data(), out->n * 4);
    return out;
}

void ma_no_cont_free(MaNoCont* p) {
    if (!p) return;
    std::free(p->names);
    std::free(p->lens);
    delete p;
}

}  // extern "C"
