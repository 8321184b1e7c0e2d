// Native data-ingestion kernels: parallel text-triple parsing and CSR
// compression.
//
// TPU-native counterpart of the reference's OpenMP fileio kernels
// (buffalo/data/fileio.hpp: chunked parse at line boundaries,
// __gnu_parallel::stable_sort + indptr emission, fileio.hpp:263-419).
// Re-designed as a two-pass mmap parser (count, then fill) plus a
// counting-sort CSR builder: counting sort by row is O(nnz) and
// perfectly parallel, and the per-row column sort runs on OpenMP
// threads — no global comparison sort needed.
//
// Exposed via a plain C ABI consumed through ctypes
// (buffalo_tpu_torch/data/fileio.py); numpy owns all buffers.

#include <omp.h>

#include <algorithm>
#include <parallel/algorithm>
#include <atomic>
#include <cstdint>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
    const char* data = nullptr;
    int64_t size = 0;
    int fd = -1;

    bool open(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0) { ::close(fd); return false; }
        size = st.st_size;
        if (size == 0) { data = nullptr; return true; }
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) { ::close(fd); return false; }
        data = static_cast<const char*>(p);
        return true;
    }

    ~MappedFile() {
        if (data) munmap(const_cast<char*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

// Advance past the current line (returns index one past '\n').
inline int64_t next_line(const char* d, int64_t pos, int64_t size) {
    while (pos < size && d[pos] != '\n') ++pos;
    return pos < size ? pos + 1 : size;
}

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Bounded integer parse: never reads at or past `end` (an mmap'd file
// whose size is an exact page multiple has NO readable byte after the
// last one, so strtoll-style unbounded scans could fault).
inline bool parse_int(const char** pp, const char* end, int64_t* out) {
    const char* p = *pp;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    int64_t x = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
        x = x * 10 + (*p - '0');
        ++p;
        any = true;
    }
    *pp = p;
    *out = neg ? -x : x;
    return any;
}

// Bounded float parse via a stack copy of the token.
inline bool parse_float(const char** pp, const char* end, double* out) {
    const char* p = *pp;
    char buf[64];
    int n = 0;
    while (p < end && !is_space(*p) && *p != '\n' && n < 63)
        buf[n++] = *p++;
    buf[n] = '\0';
    *pp = p;
    if (n == 0) return false;
    char* q;
    double v = strtod(buf, &q);
    if (q == buf) return false;
    *out = v;
    return true;
}

// Parse one whitespace-separated "int int [float]" line.  Returns the
// number of fields parsed (0 for blank/comment lines).
inline int parse_line(const char* p, const char* end, int64_t* a,
                      int64_t* b, double* v) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end || *p == '%' || *p == '\n') return 0;
    if (!parse_int(&p, end, a)) return 0;
    while (p < end && is_space(*p)) ++p;
    if (!parse_int(&p, end, b)) return 1;
    while (p < end && is_space(*p)) ++p;
    if (p >= end || *p == '\n') { *v = 1.0; return 2; }
    if (!parse_float(&p, end, v)) { *v = 1.0; return 2; }
    return 3;
}

}  // namespace

extern "C" {

// Pass 1: count data lines (non-blank, non-comment) after skip_bytes.
int64_t fileio_count_lines(const char* path, int64_t skip_bytes) {
    MappedFile f;
    if (!f.open(path)) return -1;
    const char* d = f.data;
    const int64_t size = f.size;
    if (skip_bytes >= size) return 0;

    int num_threads = omp_get_max_threads();
    std::vector<int64_t> counts(num_threads, 0);
    const int64_t span = size - skip_bytes;
    const int64_t chunk = std::max<int64_t>(1, span / num_threads);

#pragma omp parallel num_threads(num_threads)
    {
        int tid = omp_get_thread_num();
        int64_t beg = skip_bytes + tid * chunk;
        int64_t end = (tid == num_threads - 1) ? size
                                               : skip_bytes + (tid + 1) * chunk;
        if (beg > size) beg = size;
        if (end > size) end = size;
        // align to line starts (first line handled by previous chunk)
        if (tid != 0 && beg > skip_bytes) beg = next_line(d, beg - 1, size);
        if (end < size) end = next_line(d, end - 1, size);
        int64_t n = 0;
        int64_t pos = beg;
        while (pos < end) {
            int64_t a, b;
            double v;
            if (parse_line(d + pos, d + end, &a, &b, &v) >= 2) ++n;
            pos = next_line(d, pos, end);
        }
        counts[tid] = n;
    }
    int64_t total = 0;
    for (auto c : counts) total += c;
    return total;
}

// Pass 2: fill rows/cols/vals (caller-allocated, capacity elements).
// Returns number of parsed triples or -1 on error.
int64_t fileio_parse_fill(const char* path, int64_t skip_bytes,
                          int64_t* rows, int64_t* cols, float* vals,
                          int64_t capacity) {
    MappedFile f;
    if (!f.open(path)) return -1;
    const char* d = f.data;
    const int64_t size = f.size;
    if (skip_bytes >= size) return 0;

    int num_threads = omp_get_max_threads();
    const int64_t span = size - skip_bytes;
    const int64_t chunk = std::max<int64_t>(1, span / num_threads);

    // per-chunk counts, then prefix-sum for write offsets
    std::vector<int64_t> begs(num_threads), ends(num_threads),
        counts(num_threads, 0);
    for (int tid = 0; tid < num_threads; ++tid) {
        int64_t beg = skip_bytes + tid * chunk;
        int64_t end = (tid == num_threads - 1) ? size
                                               : skip_bytes + (tid + 1) * chunk;
        if (beg > size) beg = size;
        if (end > size) end = size;
        if (tid != 0 && beg > skip_bytes) beg = next_line(d, beg - 1, size);
        if (end < size) end = next_line(d, end - 1, size);
        begs[tid] = beg;
        ends[tid] = end;
    }
#pragma omp parallel for num_threads(num_threads)
    for (int tid = 0; tid < num_threads; ++tid) {
        int64_t n = 0;
        int64_t pos = begs[tid];
        while (pos < ends[tid]) {
            int64_t a, b;
            double v;
            if (parse_line(d + pos, d + ends[tid], &a, &b, &v) >= 2) ++n;
            pos = next_line(d, pos, ends[tid]);
        }
        counts[tid] = n;
    }
    std::vector<int64_t> offsets(num_threads + 1, 0);
    for (int t = 0; t < num_threads; ++t)
        offsets[t + 1] = offsets[t] + counts[t];
    if (offsets[num_threads] > capacity) return -2;

#pragma omp parallel for num_threads(num_threads)
    for (int tid = 0; tid < num_threads; ++tid) {
        int64_t out = offsets[tid];
        int64_t pos = begs[tid];
        while (pos < ends[tid]) {
            int64_t a, b;
            double v = 1.0;
            int nf = parse_line(d + pos, d + ends[tid], &a, &b, &v);
            if (nf >= 2) {
                rows[out] = a;
                cols[out] = b;
                vals[out] = (nf >= 3) ? static_cast<float>(v) : 1.0f;
                ++out;
            }
            pos = next_line(d, pos, ends[tid]);
        }
    }
    return offsets[num_threads];
}

// Stable CSR build: counting-sort triples by row (input order kept
// within a row), then sort each row's entries by column in parallel.
// indptr: int64[num_rows + 1]; out_key/out_val: int32/float[nnz].
// Returns the number of out-of-range rows DROPPED (0 = clean build);
// the caller must treat a positive return as corrupt input, since
// indptr[num_rows] < nnz leaves an uninitialized tail in out_key/out_val.
int fileio_build_csr(int64_t nnz, const int64_t* rows, const int64_t* cols,
                     const float* vals, int64_t num_rows, int64_t* indptr,
                     int32_t* out_key, float* out_val, int sort_cols) {
    std::vector<std::atomic<int64_t>> counts(num_rows);
    for (int64_t r = 0; r < num_rows; ++r)
        counts[r].store(0, std::memory_order_relaxed);

    std::atomic<int64_t> dropped(0);
#pragma omp parallel for
    for (int64_t i = 0; i < nnz; ++i) {
        int64_t r = rows[i];
        if (r < 0 || r >= num_rows) {
            dropped.fetch_add(1, std::memory_order_relaxed);
            continue;
        }
        counts[r].fetch_add(1, std::memory_order_relaxed);
    }
    indptr[0] = 0;
    for (int64_t r = 0; r < num_rows; ++r)
        indptr[r + 1] = indptr[r] + counts[r].load(std::memory_order_relaxed);

    // scatter (sequential to keep within-row input order stable)
    std::vector<int64_t> cursor(indptr, indptr + num_rows);
    for (int64_t i = 0; i < nnz; ++i) {
        int64_t r = rows[i];
        if (r < 0 || r >= num_rows) continue;
        int64_t at = cursor[r]++;
        out_key[at] = static_cast<int32_t>(cols[i]);
        out_val[at] = vals[i];
    }

    if (sort_cols) {
#pragma omp parallel for schedule(dynamic, 64)
        for (int64_t r = 0; r < num_rows; ++r) {
            int64_t beg = indptr[r], end = indptr[r + 1];
            int64_t len = end - beg;
            if (len <= 1) continue;
            std::vector<std::pair<int32_t, float>> buf(len);
            for (int64_t i = 0; i < len; ++i)
                buf[i] = {out_key[beg + i], out_val[beg + i]};
            std::stable_sort(buf.begin(), buf.end(),
                             [](const auto& a, const auto& b) {
                                 return a.first < b.first;
                             });
            for (int64_t i = 0; i < len; ++i) {
                out_key[beg + i] = buf[i].first;
                out_val[beg + i] = buf[i].second;
            }
        }
    }
    return static_cast<int>(
        std::min<int64_t>(dropped.load(), INT32_MAX));
}

// ---------------------------------------------------------------- SPPMI
// Bounded-memory shifted-positive-PMI builder (counterpart of the
// reference's chunked two-pass kernel, fileio.hpp:109-250).  The pair
// space is partitioned by HEAD item id: each call counts only pairs
// whose head falls in [head_beg, head_end), so peak memory is the
// distinct-pair count of one partition, never the full pair stream.

// Pass 0: per-item appearance counts over all symmetric pairs.
// Returns the total number of symmetric pairs (D).
int64_t fileio_sppmi_occ(int64_t n_rows, const int64_t* indptr,
                         const int32_t* keys, int64_t num_items,
                         int64_t window, double* occ) {
    for (int64_t i = 0; i < num_items; ++i) occ[i] = 0.0;
    int64_t total = 0;
#pragma omp parallel
    {
        std::vector<double> local(num_items, 0.0);
        int64_t my_total = 0;
#pragma omp for schedule(dynamic, 256)
        for (int64_t r = 0; r < n_rows; ++r) {
            int64_t beg = indptr[r], end = indptr[r + 1];
            for (int64_t i = beg; i < end; ++i) {
                int64_t hi = std::min(end, i + 1 + window);
                for (int64_t j = i + 1; j < hi; ++j) {
                    local[keys[i]] += 1.0;
                    local[keys[j]] += 1.0;
                    my_total += 2;  // (a,b) and (b,a)
                }
            }
        }
#pragma omp critical
        {
            for (int64_t i = 0; i < num_items; ++i) occ[i] += local[i];
            total += my_total;
        }
    }
    return total;
}

// One partition: count pairs with head in [head_beg, head_end), emit
// entries with pmi - log k > 0 as triples.  Returns the number of
// surviving entries; if it exceeds `cap`, nothing is written and the
// needed size is returned as a negative number (caller re-allocates).
// The partition's pair codes (head * num_items + tail) are gathered per
// thread over the OpenMP row loop, sorted once (in parallel) and counted
// as runs: exact counts, emitted in (head, tail) order.  (A hash map per
// thread merged under a lock, the earlier form, spent most of a
// KakaoBrunch-scale build in the serial merge.)
int64_t fileio_sppmi_part(int64_t n_rows, const int64_t* indptr,
                          const int32_t* keys, int64_t num_items,
                          int64_t window, double logk, const double* occ,
                          double d_total, int64_t head_beg,
                          int64_t head_end, int32_t* out_rows,
                          int32_t* out_cols, float* out_vals,
                          int64_t cap) {
    std::vector<std::vector<int64_t>> per(omp_get_max_threads());
#pragma omp parallel
    {
        std::vector<int64_t>& local = per[omp_get_thread_num()];
#pragma omp for schedule(dynamic, 256)
        for (int64_t r = 0; r < n_rows; ++r) {
            int64_t beg = indptr[r], end = indptr[r + 1];
            for (int64_t i = beg; i < end; ++i) {
                int64_t hi = std::min(end, i + 1 + window);
                for (int64_t j = i + 1; j < hi; ++j) {
                    int64_t a = keys[i], b = keys[j];
                    if (a >= head_beg && a < head_end)
                        local.push_back(a * num_items + b);
                    if (b >= head_beg && b < head_end)
                        local.push_back(b * num_items + a);
                }
            }
        }
    }
    size_t total = 0;
    for (const auto& v : per) total += v.size();
    std::vector<int64_t> codes;
    codes.reserve(total);
    for (auto& v : per) {
        codes.insert(codes.end(), v.begin(), v.end());
        std::vector<int64_t>().swap(v);
    }
    __gnu_parallel::sort(codes.begin(), codes.end());
    int64_t n_out = 0;
    for (size_t s = 0; s < codes.size();) {
        size_t e = s + 1;
        while (e < codes.size() && codes[e] == codes[s]) ++e;
        const int64_t a = codes[s] / num_items, b = codes[s] % num_items;
        const double pmi = std::log(static_cast<double>(e - s) * d_total /
                                    (occ[a] * occ[b]));
        s = e;
        if (pmi - logk <= 0) continue;
        if (n_out < cap) {
            out_rows[n_out] = static_cast<int32_t>(a);
            out_cols[n_out] = static_cast<int32_t>(b);
            out_vals[n_out] = static_cast<float>(pmi - logk);
        }
        ++n_out;
    }
    return n_out <= cap ? n_out : -n_out;
}

// ------------------------------------------------------- padded gather
// One-pass ragged-CSR gather into a padded (B, L) block — the staging
// hot loop behind the range-layout builders and batch iteration
// (counterpart of the reference's chunk fetch, buffered_data.py:85-118,
// which memcpy's CSR slices; here rows are also id-remapped into the
// permuted table's positions).  The numpy version makes ~6 full passes
// over the batch (idx/mask temporaries, two fancy gathers, two wheres,
// a cast); this fills cols/vals directly, parallel over rows.
//
// out_lens[B], out_cols[B*L], out_vals[B*L] must be PRE-ZEROED by the
// caller (padding rows/entries stay zero).  `key` is int32 or int64
// (key_is64), `val` may be null (implicit 1.0), `newpos` may be null
// (identity remap), `vals_bf16` writes bfloat16 (round-to-nearest-even,
// matching numpy's float32->bfloat16 cast) into out_vals as uint16.
static inline uint16_t f32_to_bf16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    if ((x & 0x7FFFFFFFu) > 0x7F800000u) return (uint16_t)((x >> 16) | 0x40);
    x += 0x7FFFu + ((x >> 16) & 1u);
    return (uint16_t)(x >> 16);
}

void fileio_gather_remapped(const int64_t* indptr, const int64_t* rows,
                            int64_t n_rows, const void* key, int key_is64,
                            const float* val, const int64_t* newpos,
                            int64_t L, int32_t* out_lens, int32_t* out_cols,
                            void* out_vals, int vals_bf16) {
    const int32_t* k32 = static_cast<const int32_t*>(key);
    const int64_t* k64 = static_cast<const int64_t*>(key);
    float* v32 = static_cast<float*>(out_vals);
    uint16_t* v16 = static_cast<uint16_t*>(out_vals);
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t b = 0; b < n_rows; ++b) {
        int64_t beg = indptr[rows[b]];
        int64_t len = indptr[rows[b] + 1] - beg;
        out_lens[b] = static_cast<int32_t>(len);
        int64_t n = std::min(len, L);
        int32_t* oc = out_cols + b * L;
        for (int64_t j = 0; j < n; ++j) {
            int64_t c = key_is64 ? k64[beg + j]
                                 : static_cast<int64_t>(k32[beg + j]);
            if (newpos) c = newpos[c];
            oc[j] = static_cast<int32_t>(c);
        }
        if (vals_bf16) {
            uint16_t* ov = v16 + b * L;
            for (int64_t j = 0; j < n; ++j)
                ov[j] = f32_to_bf16(val ? val[beg + j] : 1.0f);
        } else {
            float* ov = v32 + b * L;
            if (val) {
                std::memcpy(ov, val + beg, n * sizeof(float));
            } else {
                for (int64_t j = 0; j < n; ++j) ov[j] = 1.0f;
            }
        }
    }
}

// Exact positional checksum: the buffer is split into n_chunks
// contiguous ranges of little-endian int64 words (tail bytes summed
// individually into the last chunk) and each range is wrap-around
// summed into out[c].  Integer sums are exact, so ANY in-place bit
// change lands in its chunk's sum; only an exact same-chunk
// cancellation (two compensating edits) escapes.  Used by the
// retrieval staged-table cache (ops/topk._fingerprint) where the
// single-threaded numpy pass was 34% of a 10k-query serving call;
// this one runs at memory bandwidth across OpenMP threads.
void fileio_checksum(const char* data, int64_t nbytes, int64_t* out,
                     int64_t n_chunks) {
    const int64_t n_words = nbytes / 8;
    const int64_t per = n_words / n_chunks;  // last chunk takes the rest
    const uint64_t* w = reinterpret_cast<const uint64_t*>(data);
#pragma omp parallel for schedule(static)
    for (int64_t c = 0; c < n_chunks; ++c) {
        const int64_t beg = c * per;
        const int64_t end = (c == n_chunks - 1) ? n_words : beg + per;
        uint64_t s = 0;
        for (int64_t i = beg; i < end; ++i) s += w[i];
        out[c] = static_cast<int64_t>(s);
    }
    uint64_t tail = 0;
    for (int64_t i = n_words * 8; i < nbytes; ++i)
        tail += static_cast<unsigned char>(data[i]);
    out[n_chunks - 1] = static_cast<int64_t>(
        static_cast<uint64_t>(out[n_chunks - 1]) + tail);
}

// W2V skip-gram pair generation (the host half of the W2V epoch; the
// device half is ops/w2v_kernels.w2v_epoch).  Counterpart of the
// reference's per-worker sentence scan (w2v.cc:227-246): given the
// subsampled token stream words[n] (vocab ids), sentence ids sents[n]
// (non-decreasing), and per-position shrunken half-widths h[n]
// (h[y] = window - b_y, b_y ~ U[0, window); the TARGET position's h
// governs pair admission, matching the numpy path in
// models/w2v.py:_generate_pairs), emit every directed pair
// (input=words[x], target=words[y]) with 1 <= |x-y| <= window,
// sents[x] == sents[y] and |x-y| <= h[y], in position-major order
// (all pairs of input position x before those of x+1).  Two-phase so
// the caller allocates exactly: count+prefix, then fill.
int64_t fileio_w2v_pairs_count(int64_t n, const int32_t* sents,
                               const int32_t* h, int32_t window,
                               int64_t* prefix /* int64[n+1] */) {
#pragma omp parallel for schedule(static)
    for (int64_t x = 0; x < n; ++x) {
        int64_t c = 0;
        const int32_t s = sents[x];
        for (int32_t off = 1; off <= window; ++off) {
            const int64_t yl = x - off;
            if (yl >= 0 && sents[yl] == s && off <= h[yl]) ++c;
            const int64_t yr = x + off;
            if (yr < n && sents[yr] == s && off <= h[yr]) ++c;
        }
        prefix[x + 1] = c;
    }
    prefix[0] = 0;
    for (int64_t x = 0; x < n; ++x) prefix[x + 1] += prefix[x];
    return prefix[n];
}

void fileio_w2v_pairs_fill(int64_t n, const int32_t* words,
                           const int32_t* sents, const int32_t* h,
                           int32_t window, const int64_t* prefix,
                           int32_t* inputs, int32_t* targets) {
#pragma omp parallel for schedule(static)
    for (int64_t x = 0; x < n; ++x) {
        int64_t o = prefix[x];
        const int32_t s = sents[x];
        const int32_t w = words[x];
        for (int32_t off = 1; off <= window; ++off) {
            const int64_t yl = x - off;
            if (yl >= 0 && sents[yl] == s && off <= h[yl]) {
                inputs[o] = w;
                targets[o] = words[yl];
                ++o;
            }
            const int64_t yr = x + off;
            if (yr < n && sents[yr] == s && off <= h[yr]) {
                inputs[o] = w;
                targets[o] = words[yr];
                ++o;
            }
        }
    }
}

}  // extern "C"
