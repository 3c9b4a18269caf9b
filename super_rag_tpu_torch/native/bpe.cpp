// Native BPE encoder: greedy rank-ordered merge replay at C++ speed.
//
// Host-side tokenization (a copy of the JAX package's native/bpe.cpp,
// for the PyTorch port): the Python merge loop in
// super_rag_tpu_torch/models/subword.py::_encode_word is O(word_len^2)
// dict probes per word.  This module replays the SAME merges over the
// SAME word split (ASCII [a-z0-9_]+ runs on byte-lowercased text, then
// CJK codepoints appended in order — models/subword.py::_words) and must
// produce bit-identical ids; tests/test_torch_tokenization.py enforces
// that.
//
// Known divergence (documented, untested-by-design): Python str.lower()
// folds a few non-ASCII codepoints INTO ASCII (U+212A KELVIN SIGN -> k,
// U+0130 -> i+combining dot); byte-wise lowering here treats them as
// separators.  Real corpora never hit this.
//
// Vocab blob wire format (little-endian, built by
// super_rag_tpu_torch/tokenize/native_bpe.py):
//   int32 T, int32 M
//   T x { int32 len, bytes }   tokens (id = 4 + index)
//   M x { int32 len_a, bytes_a, int32 len_b, bytes_b }   merges by rank
//
// C ABI (ctypes):
//   void*   bpe_create(const char* blob, int64_t blob_len);
//   void    bpe_destroy(void* h);
//   int64_t bpe_encode(void* h, const char* text, int64_t text_len,
//                      int32_t* out, int64_t cap);
//     returns the id count (<= 2*text_len + 1); cap too small -> -1.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC bpe.cpp -o libbpe.so

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int32_t UNK_ID = 3;
constexpr int32_t NUM_SPECIAL = 4;
const std::string END = "</w>";

struct Handle {
    std::unordered_map<std::string, int32_t> tok_id;
    std::unordered_map<std::string, int32_t> rank;  // "a\x01b" -> rank
    std::unordered_map<std::string, std::vector<int32_t>> cache;
    std::mutex mu;
};

inline int32_t read_i32(const char*& p, const char* end) {
    if (p + 4 > end) return -1;
    int32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
}

inline bool read_str(const char*& p, const char* end, std::string& out) {
    int32_t n = read_i32(p, end);
    if (n < 0 || p + n > end) return false;
    out.assign(p, static_cast<size_t>(n));
    p += n;
    return true;
}

inline bool is_cjk(uint32_t cp) {
    return (cp >= 0x4E00 && cp <= 0x9FFF) ||   // 一-鿿
           (cp >= 0x3040 && cp <= 0x30FF) ||   // ぀-ヿ
           (cp >= 0xAC00 && cp <= 0xD7AF);     // 가-힯
}

// decode one UTF-8 codepoint; advances i; returns 0xFFFD on bad bytes
inline uint32_t next_cp(const char* s, int64_t n, int64_t& i, int64_t& len) {
    uint8_t c = static_cast<uint8_t>(s[i]);
    if (c < 0x80) { len = 1; i += 1; return c; }
    int need = (c >= 0xF0) ? 3 : (c >= 0xE0) ? 2 : (c >= 0xC0) ? 1 : 0;
    if (need == 0 || i + need >= n) { len = 1; i += 1; return 0xFFFD; }
    uint32_t cp = c & (0x3F >> need);
    for (int k = 1; k <= need; ++k) {
        uint8_t cc = static_cast<uint8_t>(s[i + k]);
        if ((cc & 0xC0) != 0x80) { len = 1; i += 1; return 0xFFFD; }
        cp = (cp << 6) | (cc & 0x3F);
    }
    len = need + 1;
    i += len;
    return cp;
}

// models/subword.py::_words — ASCII word runs first, CJK chars appended
void split_words(const char* s, int64_t n, std::vector<std::string>& words) {
    std::vector<std::string> cjk;
    std::string cur;
    int64_t i = 0;
    while (i < n) {
        uint8_t c = static_cast<uint8_t>(s[i]);
        if (c < 0x80) {
            char lc = (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32)
                                             : static_cast<char>(c);
            if ((lc >= 'a' && lc <= 'z') || (lc >= '0' && lc <= '9') ||
                lc == '_') {
                cur.push_back(lc);
            } else if (!cur.empty()) {
                words.push_back(std::move(cur));
                cur.clear();
            }
            ++i;
            continue;
        }
        int64_t start = i, len = 0;
        uint32_t cp = next_cp(s, n, i, len);
        if (!cur.empty()) {
            words.push_back(std::move(cur));
            cur.clear();
        }
        if (is_cjk(cp)) cjk.emplace_back(s + start, static_cast<size_t>(len));
    }
    if (!cur.empty()) words.push_back(std::move(cur));
    for (auto& w : cjk) words.push_back(std::move(w));
}

// split a word into codepoint symbols + </w> (list(w) in Python)
void word_symbols(const std::string& w, std::vector<std::string>& syms) {
    const char* s = w.data();
    int64_t n = static_cast<int64_t>(w.size()), i = 0, len = 0;
    while (i < n) {
        int64_t start = i;
        next_cp(s, n, i, len);
        syms.emplace_back(s + start, static_cast<size_t>(len));
    }
    syms.push_back(END);
}

void encode_word(Handle* h, const std::string& w, std::vector<int32_t>& out) {
    {
        std::lock_guard<std::mutex> g(h->mu);
        auto it = h->cache.find(w);
        if (it != h->cache.end()) {
            out.insert(out.end(), it->second.begin(), it->second.end());
            return;
        }
    }
    std::vector<std::string> syms;
    word_symbols(w, syms);
    std::string key;
    while (syms.size() > 1) {
        int32_t best_rank = INT32_MAX;
        size_t best_i = 0;
        for (size_t i = 0; i + 1 < syms.size(); ++i) {
            key.assign(syms[i]);
            key.push_back('\x01');
            key.append(syms[i + 1]);
            auto it = h->rank.find(key);
            if (it != h->rank.end() && it->second < best_rank) {
                best_rank = it->second;
                best_i = i;
            }
        }
        if (best_rank == INT32_MAX) break;
        syms[best_i].append(syms[best_i + 1]);
        syms.erase(syms.begin() + static_cast<long>(best_i) + 1);
    }
    std::vector<int32_t> ids;
    ids.reserve(syms.size());
    for (const auto& s : syms) {
        auto it = h->tok_id.find(s);
        ids.push_back(it == h->tok_id.end() ? UNK_ID : it->second);
    }
    out.insert(out.end(), ids.begin(), ids.end());
    std::lock_guard<std::mutex> g(h->mu);
    if (h->cache.size() < 1000000) h->cache.emplace(w, std::move(ids));
}

}  // namespace

extern "C" {

void* bpe_create(const char* blob, int64_t blob_len) {
    const char* p = blob;
    const char* end = blob + blob_len;
    int32_t T = read_i32(p, end);
    int32_t M = read_i32(p, end);
    if (T < 0 || M < 0) return nullptr;
    auto* h = new Handle();
    h->tok_id.reserve(static_cast<size_t>(T) * 2);
    h->rank.reserve(static_cast<size_t>(M) * 2);
    std::string tok, a, b;
    for (int32_t i = 0; i < T; ++i) {
        if (!read_str(p, end, tok)) { delete h; return nullptr; }
        h->tok_id.emplace(tok, NUM_SPECIAL + i);
    }
    for (int32_t i = 0; i < M; ++i) {
        if (!read_str(p, end, a) || !read_str(p, end, b)) {
            delete h;
            return nullptr;
        }
        a.push_back('\x01');
        a.append(b);
        h->rank.emplace(a, i);
    }
    return h;
}

void bpe_destroy(void* h) { delete static_cast<Handle*>(h); }

int64_t bpe_encode(void* hv, const char* text, int64_t text_len,
                   int32_t* out, int64_t cap) {
    auto* h = static_cast<Handle*>(hv);
    std::vector<std::string> words;
    split_words(text, text_len, words);
    std::vector<int32_t> ids;
    ids.reserve(static_cast<size_t>(text_len) + words.size() + 1);
    for (const auto& w : words) encode_word(h, w, ids);
    if (static_cast<int64_t>(ids.size()) > cap) return -1;
    if (!ids.empty()) std::memcpy(out, ids.data(), ids.size() * 4);
    return static_cast<int64_t>(ids.size());
}

}  // extern "C"
