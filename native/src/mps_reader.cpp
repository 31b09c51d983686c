/* hpmps — native MPS reader.  See include/hpmps.h.
 *
 * Semantics match the framework's Python reference reader
 * (hprlp_tpu/io/mps.py) line for line, which in turn documents parity with
 * the reference C++ reader (reference: src/mps_reader.cpp:360-1361):
 * row-type defaults, objective RHS -> constant = -value, RANGES rules per
 * row type, bound cards FR/MI/PL/BV/LO/UP/FX/LI/UI, default-bound
 * finalisation including the "only UP given and u < 0 => l = -inf" rule,
 * rim sets skipped with a warning, duplicates summed in COO->CSR.
 */

#include "../include/hpmps.h"

#include <zlib.h>

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <limits>
#include <memory>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#include <sys/mman.h>
#include <sys/stat.h>

namespace {

/* Pre-fault a fresh buffer in parallel with hugepage advice: page-zero
 * faulting is single-thread-bound on some VMs, while a parallel touch
 * with transparent hugepages faults 512x fewer pages concurrently. */
void parallel_touch(char *p, int64_t bytes) {
    if (!p || bytes <= 0) return;
    const uintptr_t a = ((uintptr_t)p + 4095) & ~(uintptr_t)4095;
    const uintptr_t e = ((uintptr_t)p + bytes) & ~(uintptr_t)4095;
    if (e > a) madvise((void *)a, e - a, MADV_HUGEPAGE);
    const int64_t pages = (bytes + 4095) / 4096;
    unsigned hw = std::thread::hardware_concurrency();
    const int T = (int)std::min<int64_t>(
        std::min<unsigned>(hw ? hw : 1, 8),
        std::max<int64_t>(1, pages / 1024));
    std::vector<std::thread> ts;
    for (int t = 0; t < T; ++t) {
        const int64_t lo = pages * t / T, hi = pages * (t + 1) / T;
        if (lo >= hi) continue;
        ts.emplace_back([=] {
            for (int64_t i = lo; i < hi; ++i) p[i * 4096] = 0;
        });
    }
    for (auto &th : ts) th.join();
}

constexpr double INF = std::numeric_limits<double>::infinity();
constexpr double NaN = std::numeric_limits<double>::quiet_NaN();

/* Line source reading transparently from plain or gzip files.
 *
 * Reads in 1 MB blocks and serves lines as string_views into the block
 * (a partial tail line is carried to the front of the next block), so the
 * per-line cost is one memchr — no per-line heap traffic.  MPS parsing is
 * one of the reference's three hot loops (SURVEY 3.2; reference reads
 * via fgets + per-line field copies, src/mps_reader.cpp:977). */
class LineReader {
  public:
    explicit LineReader(const char *path) {
        // PLAIN files above a threshold load fully into memory: lines
        // become direct views (no block memmove), and the COLUMNS
        // section — the giant-parse hot loop — can then be parsed in
        // PARALLEL over line-aligned chunks (parse_columns_parallel).
        // gz streams keep the block reader (decompression is inherently
        // serial and dominates anyway).
        struct stat st;
        const size_t len = std::strlen(path);
        const bool is_gz = len > 3 && !std::strcmp(path + len - 3, ".gz");
        const char *thr = std::getenv("HPRLP_MPS_PARALLEL_MIN_BYTES");
        const size_t min_sz = thr ? (size_t)std::atoll(thr) : (32u << 20);
        if (!is_gz && stat(path, &st) == 0 && (size_t)st.st_size >= min_sz) {
            if (FILE *fp = std::fopen(path, "rb")) {
                const size_t sz = (size_t)st.st_size;
                mem_.reset(new (std::nothrow) char[sz]);
                if (mem_) {
                    parallel_touch(mem_.get(), (int64_t)sz);
                    mem_len_ = std::fread(mem_.get(), 1, sz, fp);
                    mem_mode_ = true;
                }
                std::fclose(fp);
                if (mem_mode_) return;
            }
        }
        gz_ = gzopen(path, "rb");  // zlib reads uncompressed files too
        buf_.resize(1 << 20);
    }
    ~LineReader() {
        if (gz_) gzclose(gz_);
    }
    bool ok() const { return mem_mode_ || gz_ != nullptr; }

    bool mem_mode() const { return mem_mode_; }
    size_t tell() const { return pos_; }       // mem mode only
    void seek(size_t p) { pos_ = p; }          // mem mode only
    std::string_view mem() const { return {mem_.get(), mem_len_}; }

    bool getline(std::string_view &out) {
        if (mem_mode_) {
            if (pos_ >= mem_len_) return false;
            const char *base = mem_.get();
            const char *nl = (const char *)std::memchr(
                base + pos_, '\n', mem_len_ - pos_);
            const size_t eol = nl ? (size_t)(nl - base) : mem_len_;
            out = trim_cr(base + pos_, eol - pos_);
            pos_ = nl ? eol + 1 : mem_len_;
            return true;
        }
        while (true) {
            if (pos_ < len_) {
                const char *base = buf_.data();
                const char *nl = (const char *)std::memchr(
                    base + pos_, '\n', len_ - pos_);
                if (nl) {
                    size_t eol = (size_t)(nl - base);
                    out = trim_cr(base + pos_, eol - pos_);
                    pos_ = eol + 1;
                    return true;
                }
                if (eof_) {  // final line without trailing newline
                    out = trim_cr(base + pos_, len_ - pos_);
                    pos_ = len_;
                    return true;
                }
            } else if (eof_) {
                return false;
            }
            refill();
        }
    }
    bool bad() const { return bad_; }

  private:
    static std::string_view trim_cr(const char *s, size_t n) {
        while (n && (s[n - 1] == '\r' || s[n - 1] == '\n')) --n;
        return {s, n};
    }

    void refill() {
        // Move the unconsumed tail (a partial line) to the front.
        const size_t tail = len_ - pos_;
        if (tail && pos_) std::memmove(buf_.data(), buf_.data() + pos_, tail);
        len_ = tail;
        pos_ = 0;
        if (len_ == buf_.size()) buf_.resize(buf_.size() * 2);  // huge line
        const int got = gzread(gz_, buf_.data() + len_,
                               (unsigned)(buf_.size() - len_));
        if (got > 0) {
            len_ += (size_t)got;
        } else {
            eof_ = true;
            if (got < 0) {
                bad_ = true;
            } else {
                // Distinguish real EOF from a truncated/corrupt gzip
                // stream: silently treating a mid-COLUMNS truncation as
                // EOF would hand back a shorter but "valid" model (the
                // Python reader raises EOFError on the same file).
                int errnum = Z_OK;
                gzerror(gz_, &errnum);
                if (errnum != Z_OK && errnum != Z_STREAM_END) bad_ = true;
            }
        }
    }

    gzFile gz_ = nullptr;
    std::vector<char> buf_;
    std::unique_ptr<char[]> mem_;   // mem mode: the whole file
    size_t mem_len_ = 0;
    bool mem_mode_ = false;
    size_t pos_ = 0, len_ = 0;
    bool eof_ = false;
    bool bad_ = false;
};

// FIXED-format card fields (reference: read_card_fixed,
// src/mps_reader.cpp:360-483): f1 cols 2-3, f2 5-12, f3 15-22, f4 25-36,
// f5 40-47, f6 50-61 (1-based, inclusive).  Trailing empties dropped and a
// leading empty field shifts the rest left, so the result reads like a
// free-format token list; fixed format is what allows spaces in names.
void split_fixed(std::string_view line, std::vector<std::string_view> &out) {
    out.clear();
    auto fld = [&](size_t a, size_t b) -> std::string_view {
        if (line.size() <= a) return {};
        std::string_view s = line.substr(a, std::min(b, line.size()) - a);
        size_t x = s.find_first_not_of(" \t");
        if (x == std::string_view::npos) return {};
        size_t y = s.find_last_not_of(" \t");
        return s.substr(x, y - x + 1);
    };
    std::string_view fs[6] = {fld(1, 3),   fld(4, 12),  fld(14, 22),
                              fld(24, 36), fld(39, 47), fld(49, 61)};
    int nf = 6;
    while (nf > 0 && fs[nf - 1].empty()) --nf;
    const int start = (nf > 0 && fs[0].empty()) ? 1 : 0;
    for (int i = start; i < nf; ++i) out.push_back(fs[i]);
}

void split(std::string_view line, std::vector<std::string_view> &out) {
    out.clear();
    size_t i = 0;
    const size_t len = line.size();
    while (i < len) {
        while (i < len && std::isspace((unsigned char)line[i])) ++i;
        size_t start = i;
        while (i < len && !std::isspace((unsigned char)line[i])) ++i;
        if (i > start) out.push_back(line.substr(start, i - start));
    }
}

std::string upper(std::string_view sv) {
    std::string s(sv);
    for (char &ch : s) ch = (char)std::toupper((unsigned char)ch);
    return s;
}

/* Case-insensitive compare against an UPPERCASE literal, optionally
 * ignoring surrounding quotes — the hot-path replacement for
 * upper(strip_quotes(tok)) == "MARKER" which allocated two strings per
 * COLUMNS card. */
bool eq_ci_unquoted(std::string_view s, std::string_view upper_lit) {
    size_t a = 0, b = s.size();
    while (a < b && (s[a] == '\'' || s[a] == '"')) ++a;
    while (b > a && (s[b - 1] == '\'' || s[b - 1] == '"')) --b;
    if (b - a != upper_lit.size()) return false;
    for (size_t k = 0; k < upper_lit.size(); ++k)
        if ((char)std::toupper((unsigned char)s[a + k]) != upper_lit[k])
            return false;
    return true;
}

bool parse_num_slow(std::string_view s, double &out) {
    char buf[64];
    if (s.empty() || s.size() >= sizeof buf) return false;
    std::memcpy(buf, s.data(), s.size());
    buf[s.size()] = '\0';
    char *end = nullptr;
    out = std::strtod(buf, &end);
    return end == buf + s.size();
}

/* Fast decimal parse for the COLUMNS/RHS hot loop.  Handles
 * [+-]?digits[.digits][eE[+-]digits] with <= 15 significant digits and
 * a decimal exponent in [-22, 22]: mantissa fits 2^53 exactly and the
 * power of ten is an exact double, so one multiply/divide is correctly
 * rounded (Clinger 1990) — bit-identical to strtod on this range, which
 * covers essentially every MPS coefficient.  Anything else (long
 * mantissas, inf/nan, hex) falls back to strtod.  strtod itself costs
 * ~150 ns/call through locale plumbing; this is ~10 ns. */
bool parse_num(std::string_view s, double &out) {
    static const double P10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,
                                 1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
                                 1e12, 1e13, 1e14, 1e15, 1e16, 1e17,
                                 1e18, 1e19, 1e20, 1e21, 1e22};
    const char *p = s.data(), *end = p + s.size();
    if (p == end) return false;
    bool neg = false;
    if (*p == '+' || *p == '-') {
        neg = *p == '-';
        ++p;
    }
    uint64_t mant = 0;
    int sig = 0;      // significant digits accumulated
    int frac = 0;     // digits after the decimal point
    bool any = false, seen_dot = false, overflow = false;
    for (; p < end; ++p) {
        const char ch = *p;
        if (ch >= '0' && ch <= '9') {
            any = true;
            if (mant == 0 && ch == '0') {
                if (seen_dot) ++frac;  // leading 0.000x zeros
                continue;
            }
            if (sig >= 15) {
                overflow = true;
                break;
            }
            mant = mant * 10 + (uint64_t)(ch - '0');
            ++sig;
            if (seen_dot) ++frac;
        } else if (ch == '.' && !seen_dot) {
            seen_dot = true;
        } else {
            break;
        }
    }
    if (!any || overflow) return parse_num_slow(s, out);
    int eexp = 0;
    if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        bool eneg = false;
        if (p < end && (*p == '+' || *p == '-')) {
            eneg = *p == '-';
            ++p;
        }
        if (p == end) return false;
        for (; p < end; ++p) {
            if (*p < '0' || *p > '9') return parse_num_slow(s, out);
            eexp = eexp * 10 + (*p - '0');
            if (eexp > 400) return parse_num_slow(s, out);
        }
        if (eneg) eexp = -eexp;
    }
    if (p != end) return parse_num_slow(s, out);
    const int dec = eexp - frac;
    if (dec < -22 || dec > 22) return parse_num_slow(s, out);
    double v = (double)mant;
    v = dec >= 0 ? v * P10[dec] : v / P10[-dec];
    out = neg ? -v : v;
    return true;
}

/* Open-addressing name table (linear probing, power-of-two capacity,
 * hash stored inline).  A node-based unordered_map<string_view,...> cost
 * ~500 ns per lookup at 1M names (2+ cache misses chasing the bucket
 * chain) and was 77% of the whole-parse gprof profile; a flat probe is
 * ~one cache line.  The reference sizes a djb2 chained table from the
 * file size for the same reason (reference: mps_reader.cpp:117-215,
 * :222-256).  Keys must point at stable storage (the Parser name arena).
 */
class NameMap {
  public:
    NameMap() { slots_.resize(cap_); }

    int64_t *find(std::string_view k) {
        const uint64_t h = mix(k);
        size_t i = (size_t)h & (cap_ - 1);
        while (slots_[i].used) {
            if (slots_[i].h == h && slots_[i].key == k)
                return &slots_[i].val;
            i = (i + 1) & (cap_ - 1);
        }
        return nullptr;
    }
    size_t count(std::string_view k) { return find(k) ? 1 : 0; }

    void emplace(std::string_view stable_key, int64_t v) {
        if ((size_ + 1) * 4 > cap_ * 3) grow();
        insert_nogrow({stable_key, mix(stable_key), v, true});
        ++size_;
    }

  private:
    struct Slot {
        std::string_view key;
        uint64_t h = 0;
        int64_t val = 0;
        bool used = false;
    };

    static uint64_t mix(std::string_view k) {
        uint64_t h = std::hash<std::string_view>{}(k);
        h ^= h >> 33;                 // spread into the probe bits
        return h | 1;                 // never 0, 'used' carries emptiness
    }

    void insert_nogrow(const Slot &s) {
        size_t i = (size_t)s.h & (cap_ - 1);
        while (slots_[i].used) i = (i + 1) & (cap_ - 1);
        slots_[i] = s;
    }

    void grow() {
        std::vector<Slot> old = std::move(slots_);
        cap_ *= 2;
        slots_.assign(cap_, Slot());
        for (const Slot &s : old)
            if (s.used) insert_nogrow(s);
    }

    size_t cap_ = 1 << 12;
    size_t size_ = 0;
    std::vector<Slot> slots_;
};

struct Parser {
    // Name maps are keyed by string_view into an arena of stable
    // std::strings (deque never relocates elements), so lookups from
    // in-buffer line tokens are allocation-free; only first-seen names
    // are copied.
    std::deque<std::string> name_arena;
    std::string_view intern(std::string_view s) {
        name_arena.emplace_back(s);
        return name_arena.back();
    }

    // Row bookkeeping: objective = 0, constraints 1-based, rim obj = -1,
    // unknown = absent (mirrors hprlp_tpu/io/mps.py).
    NameMap con_index;
    std::vector<char> con_types;
    std::vector<double> lcon, ucon;

    NameMap var_index;
    std::vector<double> lvar, uvar, cvec;

    std::vector<int64_t> rows_i, cols_j;
    std::vector<double> vals;

    std::string model_name, error;
    double c0 = 0.0;
    int objsense = 1;
    int status = HPMPS_OK;
    bool saw_quadobj = false;

    std::string rhsname, rngname, bndname;
    bool have_rhsname = false, have_rngname = false, have_bndname = false;
    bool have_objname = false;

    int64_t get_var(std::string_view vname) {
        if (const int64_t *v = var_index.find(vname)) return *v;
        int64_t j = (int64_t)lvar.size();
        var_index.emplace(intern(vname), j);
        lvar.push_back(NaN);
        uvar.push_back(NaN);
        cvec.push_back(0.0);
        return j;
    }

    void apply_rhs(std::string_view rowname, double val) {
        const int64_t *rp = con_index.find(rowname);
        if (!rp) return;  // unknown row: warn-and-skip
        int64_t row = *rp;
        if (row == 0) {
            c0 = -val;  // objective constant (reference: :767)
        } else if (row > 0) {
            int64_t idx = row - 1;
            switch (con_types[idx]) {
                case 'E': lcon[idx] = val; ucon[idx] = val; break;
                case 'L': ucon[idx] = val; break;
                case 'G': lcon[idx] = val; break;
            }
        }
    }

    void apply_range(std::string_view rowname, double val) {
        const int64_t *rp = con_index.find(rowname);
        if (!rp || *rp <= 0) return;
        int64_t idx = *rp - 1;
        switch (con_types[idx]) {
            case 'E':
                if (val >= 0.0) ucon[idx] += val;
                else lcon[idx] += val;
                break;
            case 'L': lcon[idx] = ucon[idx] - std::fabs(val); break;
            case 'G': ucon[idx] = lcon[idx] + std::fabs(val); break;
        }
    }
};

/* Parallel COLUMNS parse (mem-mode reader only).
 *
 * The COLUMNS section dominates giant parses (~nnz cards; the round-4
 * profile measured the single-threaded tokenizer loop as the new
 * bottleneck at 31.5 MB/s).  Three passes:
 *
 *   1. one memchr sweep records line starts and finds the section end
 *      (the first column-0 non-space, non-'*' line);
 *   2. a SERIAL prepass assigns variable ids in first-appearance order
 *      (get_var mutates var_index/name_arena — ids must match the
 *      serial reader exactly) while only peeking at the first tokens;
 *   3. the full tokenize + number-parse + row-lookup work — the
 *      expensive part — runs on threads over line-aligned chunks into
 *      per-thread COO arenas, merged in chunk order so the triplet
 *      order is bit-identical to the serial parse.  con_index/var_index
 *      are read-only in this pass.
 *
 * On a malformed number the earliest offending line wins (serial parity:
 * FORMAT_ERROR status; the model is discarded either way). */
void parse_columns_parallel(Parser &p, LineReader &rd, bool fixed_format) {
    const std::string_view mem = rd.mem();
    const size_t start = rd.tell();

    // Pass 1: line starts + section end.
    std::vector<std::pair<uint64_t, uint32_t>> lines;  // (offset, length)
    lines.reserve((mem.size() - start) / 24);
    size_t pos = start;
    size_t section_end = mem.size();
    while (pos < mem.size()) {
        const char c0 = mem[pos];
        const char *nl = (const char *)std::memchr(
            mem.data() + pos, '\n', mem.size() - pos);
        const size_t eol = nl ? (size_t)(nl - mem.data()) : mem.size();
        if (c0 != ' ' && c0 != '\t' && c0 != '*' && c0 != '\r'
            && c0 != '\n') {
            section_end = pos;  // next section header
            break;
        }
        size_t len = eol - pos;
        while (len && (mem[pos + len - 1] == '\r')) --len;
        if (len) lines.emplace_back(pos, (uint32_t)len);
        pos = nl ? eol + 1 : mem.size();
    }

    // Pass 2: serial variable-id prepass.
    std::vector<int64_t> vids(lines.size(), -1);
    {
        std::vector<std::string_view> f;
        for (size_t i = 0; i < lines.size(); ++i) {
            std::string_view line(mem.data() + lines[i].first,
                                  lines[i].second);
            size_t ns = line.find_first_not_of(" \t");
            if (ns == std::string_view::npos || line[ns] == '*') continue;
            if (fixed_format) {
                split_fixed(line, f);
                if (f.size() >= 3 && eq_ci_unquoted(f[1], "MARKER"))
                    continue;
                if (f.size() < 3) continue;
                vids[i] = p.get_var(f[0]);
            } else {
                // Peek the first three tokens without a full split.
                std::string_view t[3];
                size_t k = 0, q = 0;
                const size_t n = line.size();
                while (q < n && k < 3) {
                    while (q < n && std::isspace((unsigned char)line[q]))
                        ++q;
                    size_t a = q;
                    while (q < n && !std::isspace((unsigned char)line[q]))
                        ++q;
                    if (q > a) t[k++] = line.substr(a, q - a);
                }
                if (k >= 3 && eq_ci_unquoted(t[1], "MARKER")) continue;
                if (k < 3) continue;
                vids[i] = p.get_var(t[0]);
            }
        }
    }

    // Pass 3: parallel tokenize/parse into per-thread arenas.
    unsigned nt = std::thread::hardware_concurrency();
    if (nt == 0) nt = 1;
    nt = std::min<unsigned>(std::min<size_t>(nt, 16),
                            (unsigned)std::max<size_t>(lines.size() / 4096,
                                                       1));
    struct Arena {
        std::vector<int64_t> rows, cols;
        std::vector<double> vals;
        std::vector<std::pair<int64_t, double>> obj;
        size_t err_line = SIZE_MAX;
        std::string err;
    };
    std::vector<Arena> arenas(nt);
    auto worker = [&](unsigned t) {
        Arena &ar = arenas[t];
        const size_t lo = lines.size() * t / nt;
        const size_t hi = lines.size() * (t + 1) / nt;
        ar.rows.reserve((hi - lo) * 2);
        ar.cols.reserve((hi - lo) * 2);
        ar.vals.reserve((hi - lo) * 2);
        std::vector<std::string_view> f;
        for (size_t i = lo; i < hi; ++i) {
            if (vids[i] < 0) continue;
            std::string_view line(mem.data() + lines[i].first,
                                  lines[i].second);
            if (fixed_format) split_fixed(line, f);
            else split(line, f);
            const int64_t j = vids[i];
            for (size_t k = 1; k + 1 < f.size(); k += 2) {
                double val;
                if (!parse_num(f[k + 1], val)) {
                    if (i < ar.err_line) {
                        ar.err_line = i;
                        ar.err = "bad number '" + std::string(f[k + 1])
                                 + "' in COLUMNS";
                    }
                    break;
                }
                const int64_t *rp = p.con_index.find(f[k]);
                if (!rp) continue;
                const int64_t row = *rp;
                if (row == 0) ar.obj.emplace_back(j, val);
                else if (row > 0) {
                    ar.rows.push_back(row - 1);
                    ar.cols.push_back(j);
                    ar.vals.push_back(val);
                }
            }
        }
    };
    if (nt == 1) {
        worker(0);
    } else {
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t) ts.emplace_back(worker, t);
        for (auto &th : ts) th.join();
    }

    // Merge in chunk order (triplet order == serial order).
    size_t add = 0;
    for (const Arena &ar : arenas) add += ar.vals.size();
    p.rows_i.reserve(p.rows_i.size() + add);
    p.cols_j.reserve(p.cols_j.size() + add);
    p.vals.reserve(p.vals.size() + add);
    size_t best_err = SIZE_MAX;
    for (const Arena &ar : arenas) {
        p.rows_i.insert(p.rows_i.end(), ar.rows.begin(), ar.rows.end());
        p.cols_j.insert(p.cols_j.end(), ar.cols.begin(), ar.cols.end());
        p.vals.insert(p.vals.end(), ar.vals.begin(), ar.vals.end());
        for (const auto &jv : ar.obj) p.cvec[jv.first] += jv.second;
        if (ar.err_line < best_err) {
            best_err = ar.err_line;
            p.status = HPMPS_FORMAT_ERROR;
            p.error = ar.err;
        }
    }
    rd.seek(section_end);
}

}  // namespace

struct hpmps_handle {
    Parser p;
    // Final CSR.
    std::vector<int64_t> Ap;
    std::vector<int32_t> Ai;
    std::vector<double> Ax;
};

static void finalize(hpmps_handle *h, int ignore_quadobj) {
    Parser &p = h->p;
    if (p.status != HPMPS_OK) return;  // parse already failed
    if (p.saw_quadobj && !ignore_quadobj) {
        p.status = HPMPS_FORMAT_ERROR;
        p.error = "QUADOBJ/QMATRIX present - this is an LP solver";
        return;
    }
    const int64_t n = (int64_t)p.lvar.size();
    if (n == 0) {
        p.status = HPMPS_FORMAT_ERROR;
        p.error = "no variables";
        return;
    }
    // Default-bound finalisation (reference: :1156-1181).
    for (int64_t j = 0; j < n; ++j) {
        const bool no_lo = std::isnan(p.lvar[j]);
        const bool no_up = std::isnan(p.uvar[j]);
        if (no_lo && no_up) {
            p.lvar[j] = 0.0;
            p.uvar[j] = INF;
        } else if (no_lo) {
            p.lvar[j] = p.uvar[j] < 0 ? -INF : 0.0;
        } else if (no_up) {
            p.uvar[j] = INF;
        }
    }
    if (p.objsense == -1) {
        for (double &v : p.cvec) v = -v;
        p.c0 = -p.c0;
    }
    // COO -> CSR with duplicate summing (reference: :1266-1361).
    // Parallel counting sort + per-row-range sort/dedup: the serial
    // version was ~40% of large-file parse wall.
    const int64_t m = (int64_t)p.con_types.size();
    const int64_t coo = (int64_t)p.vals.size();
    unsigned hw = std::thread::hardware_concurrency();
    const int T = coo >= 2'000'000
                      ? (int)std::min<int64_t>(hw ? hw : 1, 8)
                      : 1;
    std::vector<std::pair<int64_t, int64_t>> spans;
    for (int t = 0; t < T; ++t) {
        int64_t lo = coo * t / T, hi = coo * (t + 1) / T;
        if (lo < hi) spans.emplace_back(lo, hi);
    }

    // Per-thread row histograms -> global Ap + per-thread cursors.
    std::vector<std::vector<int64_t>> cnt(spans.size());
    {
        std::vector<std::thread> ts;
        for (size_t t = 0; t < spans.size(); ++t)
            ts.emplace_back([&, t] {
                auto &c = cnt[t];
                c.assign(m, 0);
                for (int64_t k = spans[t].first; k < spans[t].second; ++k)
                    c[p.rows_i[k]]++;
            });
        for (auto &th : ts) th.join();
    }
    h->Ap.assign(m + 1, 0);
    for (int64_t i = 0; i < m; ++i) {
        int64_t acc = h->Ap[i];
        for (size_t t = 0; t < spans.size(); ++t) {
            int64_t c = cnt[t][i];
            cnt[t][i] = acc;  // becomes this thread's scatter cursor
            acc += c;
        }
        h->Ap[i + 1] = acc;
    }
    std::vector<std::pair<int32_t, double>> pr(coo);
    {
        std::vector<std::thread> ts;
        for (size_t t = 0; t < spans.size(); ++t)
            ts.emplace_back([&, t] {
                auto &cur = cnt[t];
                for (int64_t k = spans[t].first; k < spans[t].second; ++k)
                    pr[cur[p.rows_i[k]]++] = {(int32_t)p.cols_j[k],
                                              p.vals[k]};
            });
        for (auto &th : ts) th.join();
    }

    // Sort each row (parallel over contiguous row ranges) and count the
    // deduped length per row.
    std::vector<int64_t> rspan(T + 1, 0);
    for (int t = 1; t < T; ++t) {
        // Cut row ranges at roughly equal ENTRY counts.
        int64_t target = coo * t / T;
        rspan[t] = (int64_t)(std::upper_bound(h->Ap.begin(),
                                              h->Ap.end(), target)
                             - h->Ap.begin()) - 1;
        rspan[t] = std::max(rspan[t], rspan[t - 1]);
    }
    rspan[T] = m;
    std::vector<int64_t> uniq(m, 0);
    {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t)
            ts.emplace_back([&, t] {
                for (int64_t i = rspan[t]; i < rspan[t + 1]; ++i) {
                    auto b = pr.begin() + h->Ap[i];
                    auto e = pr.begin() + h->Ap[i + 1];
                    std::sort(b, e, [](auto &a, auto &c) {
                        return a.first < c.first;
                    });
                    int64_t u = 0;
                    int32_t prev = -1;
                    for (auto it = b; it != e; ++it)
                        if (it->first != prev) {
                            ++u;
                            prev = it->first;
                        }
                    uniq[i] = u;
                }
            });
        for (auto &th : ts) th.join();
    }
    std::vector<int64_t> newAp(m + 1, 0);
    for (int64_t i = 0; i < m; ++i) newAp[i + 1] = newAp[i] + uniq[i];
    h->Ai.assign((size_t)newAp[m], 0);
    h->Ax.assign((size_t)newAp[m], 0.0);
    {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t)
            ts.emplace_back([&, t] {
                for (int64_t i = rspan[t]; i < rspan[t + 1]; ++i) {
                    int64_t o = newAp[i] - 1;
                    int32_t prev = -1;
                    for (int64_t e = h->Ap[i]; e < h->Ap[i + 1]; ++e) {
                        if (pr[e].first != prev) {
                            prev = pr[e].first;
                            ++o;
                            h->Ai[o] = prev;
                            h->Ax[o] = pr[e].second;
                        } else {
                            h->Ax[o] += pr[e].second;
                        }
                    }
                }
            });
        for (auto &th : ts) th.join();
    }
    h->Ap = std::move(newAp);
}

extern "C" {

hpmps_handle *hpmps_read_ex(const char *path, int ignore_quadobj,
                            int fixed_format) {
    auto *h = new hpmps_handle();
    Parser &p = h->p;
    LineReader rd(path);
    if (!rd.ok()) {
        p.status = HPMPS_IO_ERROR;
        p.error = std::string("cannot open ") + path;
        return h;
    }

    // Reserve COO capacity from the file size (reference capacity
    // heuristics: src/mps_reader.cpp:222-256): a COLUMNS card entry is
    // ~25 bytes of text; growth reallocations of three multi-GB vectors
    // were a measurable slice of giant parses.  Gz files assume ~4x
    // compression.  Cap so a wild guess can't exhaust memory.  The
    // reserved capacity is PRE-FAULTED in parallel (parallel_touch):
    // page-zero faulting is single-thread-bound on some VMs, and the
    // parse loop's push_backs otherwise fault the whole span serially.
    {
        struct stat st;
        if (stat(path, &st) == 0 && st.st_size > (1 << 20)) {
            size_t sz = (size_t)st.st_size;
            const size_t len = std::strlen(path);
            if (len > 3 && std::strcmp(path + len - 3, ".gz") == 0)
                sz *= 4;
            const size_t est = std::min<size_t>(sz / 25, 400'000'000);
            p.rows_i.reserve(est);
            p.cols_j.reserve(est);
            p.vals.reserve(est);
            parallel_touch((char *)p.rows_i.data(),
                                 (int64_t)(est * sizeof(int64_t)));
            parallel_touch((char *)p.cols_j.data(),
                                 (int64_t)(est * sizeof(int64_t)));
            parallel_touch((char *)p.vals.data(),
                                 (int64_t)(est * sizeof(double)));
        }
    }

    enum Sec { NONE, NAME, OBJSENSE, ROWS, COLUMNS, RHS, RANGES, BOUNDS,
               QUAD } sec = NONE;
    bool pending_objsense = false;
    std::string_view line;
    std::vector<std::string_view> f;

    while (rd.getline(line)) {
        if (line.empty()) continue;
        size_t first_ns = line.find_first_not_of(" \t");
        if (first_ns == std::string_view::npos) continue;
        if (line[first_ns] == '*') continue;

        const bool is_header = !std::isspace((unsigned char)line[0]);
        if (is_header || !fixed_format) split(line, f);
        else split_fixed(line, f);
        if (f.empty()) continue;

        if (is_header) {
            const std::string head = upper(f[0]);
            if (head == "NAME") {
                if (fixed_format) {
                    // Fixed format: model name starts at column 15 and may
                    // contain spaces (reference: :394-398).
                    if (line.size() > 14) {
                        std::string_view nm = line.substr(14);
                        size_t x = nm.find_first_not_of(" \t");
                        size_t y = nm.find_last_not_of(" \t\r");
                        p.model_name = (x == std::string_view::npos)
                                           ? std::string()
                                           : std::string(
                                                 nm.substr(x, y - x + 1));
                    } else {
                        p.model_name.clear();
                    }
                } else {
                    p.model_name = f.size() > 1 ? std::string(f[1]) : "";
                }
                sec = NAME;
            } else if (head == "OBJSENSE") {
                sec = OBJSENSE;
                if (f.size() > 1) {
                    p.objsense = upper(f[1]).rfind("MAX", 0) == 0 ? -1 : 1;
                    pending_objsense = false;
                } else {
                    pending_objsense = true;
                }
            } else if (head == "ROWS") sec = ROWS;
            else if (head == "COLUMNS") {
                sec = COLUMNS;
                if (rd.mem_mode()) {
                    // Hot section, whole file in memory: parse it in
                    // parallel and resume at the next section header.
                    parse_columns_parallel(p, rd, fixed_format);
                }
            }
            else if (head == "RHS") sec = RHS;
            else if (head == "RANGES") sec = RANGES;
            else if (head == "BOUNDS") sec = BOUNDS;
            else if (head == "QUADOBJ" || head == "QMATRIX") sec = QUAD;
            else if (head == "ENDATA") break;
            else sec = NONE;
            continue;
        }

        if (pending_objsense && sec == OBJSENSE) {
            p.objsense = upper(f[0]).rfind("MAX", 0) == 0 ? -1 : 1;
            pending_objsense = false;
            continue;
        }

        switch (sec) {
            case ROWS: {
                if (f.size() < 2) continue;
                const std::string rtype = upper(f[0]);
                const std::string_view rowname = f[1];
                // Duplicate row names are malformed MPS: routing the
                // entries to either the first or the last row of the
                // name silently builds a different matrix (and the two
                // framework readers used to disagree on which).
                if (p.con_index.count(rowname)) {
                    p.status = HPMPS_FORMAT_ERROR;
                    p.error = "duplicate row name " + std::string(rowname);
                    break;
                }
                if (rtype == "N") {
                    if (!p.have_objname) {
                        p.have_objname = true;
                        p.con_index.emplace(p.intern(rowname), 0);
                    } else {
                        // rim objective
                        p.con_index.emplace(p.intern(rowname), -1);
                    }
                    continue;
                }
                if (rtype != "E" && rtype != "L" && rtype != "G") continue;
                p.con_index.emplace(p.intern(rowname),
                                    (int64_t)p.con_types.size() + 1);
                p.con_types.push_back(rtype[0]);
                if (rtype == "E") {
                    p.lcon.push_back(0.0);
                    p.ucon.push_back(0.0);
                } else if (rtype == "G") {
                    p.lcon.push_back(0.0);
                    p.ucon.push_back(INF);
                } else {
                    p.lcon.push_back(-INF);
                    p.ucon.push_back(0.0);
                }
                break;
            }
            case COLUMNS: {
                if (f.size() >= 3 && eq_ci_unquoted(f[1], "MARKER"))
                    continue;  // INTORG/INTEND: integrality dropped for LP
                if (f.size() < 3) continue;
                const int64_t j = p.get_var(f[0]);
                for (size_t k = 1; k + 1 < f.size(); k += 2) {
                    double val;
                    if (!parse_num(f[k + 1], val)) {
                        // A malformed value must fail, not silently drop
                        // the coefficient (Python reader parity: float()
                        // raises).
                        p.status = HPMPS_FORMAT_ERROR;
                        p.error = "bad number '" + std::string(f[k + 1])
                                  + "' in COLUMNS";
                        break;
                    }
                    const int64_t *rp = p.con_index.find(f[k]);
                    if (!rp) continue;
                    const int64_t row = *rp;
                    if (row == 0) p.cvec[j] += val;
                    else if (row > 0) {
                        p.rows_i.push_back(row - 1);
                        p.cols_j.push_back(j);
                        p.vals.push_back(val);
                    }
                }
                break;
            }
            case RHS:
            case RANGES: {
                if (f.size() < 2) continue;
                size_t start;
                // Set name may be omitted when the first field is a row.
                if (f.size() % 2 == 0 && p.con_index.count(f[0])) {
                    start = 0;
                } else {
                    std::string &setname = sec == RHS ? p.rhsname : p.rngname;
                    bool &have = sec == RHS ? p.have_rhsname : p.have_rngname;
                    if (!have) {
                        setname = std::string(f[0]);
                        have = true;
                    } else if (std::string_view(setname) != f[0]) {
                        continue;  // rim set skipped
                    }
                    start = 1;
                }
                for (size_t k = start; k + 1 < f.size(); k += 2) {
                    double val;
                    if (!parse_num(f[k + 1], val)) {
                        p.status = HPMPS_FORMAT_ERROR;
                        p.error = "bad number '" + std::string(f[k + 1])
                                  + "' in "
                                  + (sec == RHS ? "RHS" : "RANGES");
                        break;
                    }
                    if (sec == RHS) p.apply_rhs(f[k], val);
                    else p.apply_range(f[k], val);
                }
                break;
            }
            case BOUNDS: {
                if (f.size() < 2) continue;
                const std::string btype = upper(f[0]);
                const bool valueless = btype == "FR" || btype == "MI" ||
                                       btype == "PL" || btype == "BV";
                std::string_view setn, vname;
                double val = 0.0;
                bool have_set = false;
                if (valueless) {
                    if (f.size() >= 3) {
                        setn = f[1];
                        vname = f[2];
                        have_set = true;
                    } else if (p.var_index.count(f[1])) {
                        vname = f[1];
                    } else {
                        continue;
                    }
                } else {
                    if (f.size() >= 4) {
                        if (!parse_num(f[3], val)) {
                            p.status = HPMPS_FORMAT_ERROR;
                            p.error = "bad number '" + std::string(f[3])
                                      + "' in BOUNDS";
                            break;
                        }
                        setn = f[1];
                        vname = f[2];
                        have_set = true;
                    } else if (f.size() == 3 && p.var_index.count(f[1])) {
                        if (!parse_num(f[2], val)) {
                            p.status = HPMPS_FORMAT_ERROR;
                            p.error = "bad number '" + std::string(f[2])
                                      + "' in BOUNDS";
                            break;
                        }
                        vname = f[1];
                    } else {
                        continue;
                    }
                }
                if (have_set) {
                    if (!p.have_bndname) {
                        p.bndname = std::string(setn);
                        p.have_bndname = true;
                    } else if (std::string_view(p.bndname) != setn) {
                        continue;  // rim bound set skipped
                    }
                }
                const int64_t *jp = p.var_index.find(vname);
                if (!jp) continue;
                const int64_t j = *jp;
                if (btype == "FR") { p.lvar[j] = -INF; p.uvar[j] = INF; }
                else if (btype == "MI") p.lvar[j] = -INF;
                else if (btype == "PL") p.uvar[j] = INF;
                else if (btype == "BV") { p.lvar[j] = 0.0; p.uvar[j] = 1.0; }
                else if (btype == "LO" || btype == "LI") p.lvar[j] = val;
                else if (btype == "UP" || btype == "UI") p.uvar[j] = val;
                else if (btype == "FX") { p.lvar[j] = val; p.uvar[j] = val; }
                break;
            }
            case QUAD:
                p.saw_quadobj = true;
                break;
            default:
                break;
        }
        if (p.status != HPMPS_OK) break;  // parse error: stop reading
    }

    if (p.status == HPMPS_OK && rd.bad()) {
        p.status = HPMPS_IO_ERROR;
        p.error = std::string("truncated or corrupt stream: ") + path;
    }
    finalize(h, ignore_quadobj);
    return h;
}

hpmps_handle *hpmps_read(const char *path, int ignore_quadobj) {
    return hpmps_read_ex(path, ignore_quadobj, /*fixed_format=*/0);
}

int hpmps_status(const hpmps_handle *h) { return h->p.status; }
const char *hpmps_error(const hpmps_handle *h) { return h->p.error.c_str(); }
int64_t hpmps_m(const hpmps_handle *h) {
    return (int64_t)h->p.con_types.size();
}
int64_t hpmps_n(const hpmps_handle *h) { return (int64_t)h->p.lvar.size(); }
int64_t hpmps_nnz(const hpmps_handle *h) { return (int64_t)h->Ax.size(); }
double hpmps_obj_constant(const hpmps_handle *h) { return h->p.c0; }
int hpmps_objsense(const hpmps_handle *h) { return h->p.objsense; }
const char *hpmps_name(const hpmps_handle *h) {
    return h->p.model_name.c_str();
}

void hpmps_get(const hpmps_handle *h, int64_t *Ap, int32_t *Ai, double *Ax,
               double *AL, double *AU, double *l, double *u, double *c) {
    const Parser &p = h->p;
    const int64_t m = (int64_t)p.con_types.size();
    const int64_t n = (int64_t)p.lvar.size();
    std::memcpy(Ap, h->Ap.data(), sizeof(int64_t) * (m + 1));
    std::memcpy(Ai, h->Ai.data(), sizeof(int32_t) * h->Ai.size());
    std::memcpy(Ax, h->Ax.data(), sizeof(double) * h->Ax.size());
    std::memcpy(AL, p.lcon.data(), sizeof(double) * m);
    std::memcpy(AU, p.ucon.data(), sizeof(double) * m);
    std::memcpy(l, p.lvar.data(), sizeof(double) * n);
    std::memcpy(u, p.uvar.data(), sizeof(double) * n);
    std::memcpy(c, p.cvec.data(), sizeof(double) * n);
}

void hpmps_free(hpmps_handle *h) { delete h; }

}  // extern "C"
