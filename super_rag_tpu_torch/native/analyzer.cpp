// Native lexical analyzer: tokenize + FNV-1a hash + doc-term table build.
//
// The host-side ingest hot path (a copy of the JAX package's
// native/analyzer.cpp, for the PyTorch port).  Must produce EXACTLY the
// same term buckets as super_rag_tpu_torch/tokenize/analyzer.py: ASCII
// [a-z0-9_]+ words on lowercased text, CJK runs as character bigrams
// (single char if the run length is 1), optional English stopword removal,
// bucket = fnv1a32(utf8(token)) & (vocab_size - 1);
// tests/test_torch_native_analyzer.py enforces that.
//
// Exposed as a C ABI for ctypes; super_rag_tpu_torch/tokenize/native.py
// builds it with g++ at first use.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <algorithm>

namespace {

inline uint32_t fnv1a32(const char* data, size_t n) {
    uint32_t h = 0x811C9DC5u;
    for (size_t i = 0; i < n; ++i) {
        h ^= static_cast<uint8_t>(data[i]);
        h *= 0x01000193u;
    }
    return h;
}

inline bool is_word_char(char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '_';
}

inline char ascii_lower(char c) {
    return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c;
}

// CJK ranges mirrored from analyzer.py's _CJK_RE:
//   U+4E00..U+9FFF (unified ideographs), U+3040..U+30FF (kana),
//   U+AC00..U+D7AF (hangul)
inline bool is_cjk(uint32_t cp) {
    return (cp >= 0x4E00 && cp <= 0x9FFF) ||
           (cp >= 0x3040 && cp <= 0x30FF) ||
           (cp >= 0xAC00 && cp <= 0xD7AF);
}

// Decode one UTF-8 codepoint; returns bytes consumed (0 on invalid).
inline int utf8_decode(const char* s, size_t remaining, uint32_t* cp) {
    const uint8_t b0 = static_cast<uint8_t>(s[0]);
    if (b0 < 0x80) { *cp = b0; return 1; }
    if ((b0 >> 5) == 0x6 && remaining >= 2) {
        *cp = ((b0 & 0x1F) << 6) | (static_cast<uint8_t>(s[1]) & 0x3F);
        return 2;
    }
    if ((b0 >> 4) == 0xE && remaining >= 3) {
        *cp = ((b0 & 0x0F) << 12) |
              ((static_cast<uint8_t>(s[1]) & 0x3F) << 6) |
              (static_cast<uint8_t>(s[2]) & 0x3F);
        return 3;
    }
    if ((b0 >> 3) == 0x1E && remaining >= 4) {
        *cp = ((b0 & 0x07) << 18) |
              ((static_cast<uint8_t>(s[1]) & 0x3F) << 12) |
              ((static_cast<uint8_t>(s[2]) & 0x3F) << 6) |
              (static_cast<uint8_t>(s[3]) & 0x3F);
        return 4;
    }
    *cp = 0xFFFD;
    return 1;
}

const std::unordered_set<std::string>& stopwords() {
    // must equal analyzer.py _STOPWORDS
    static const std::unordered_set<std::string> kStop = {
        "a", "an", "and", "are", "as", "at", "be", "by", "for", "from",
        "has", "have", "in", "is", "it", "its", "of", "on", "or", "that",
        "the", "this", "to", "was", "were", "will", "with", "not", "but",
        "they", "you", "we", "he", "she", "i",
    };
    return kStop;
}

// Tokenize into hashed buckets; returns total token count (doc_len).
// Word tokens are emitted in text order first, then CJK bigrams per run —
// matching Analyzer.tokens() which concatenates words then CJK bigrams.
int64_t analyze_one(const char* text, size_t len, uint32_t mask,
                    bool use_stopwords, std::vector<uint32_t>* out) {
    std::string word;
    std::vector<uint32_t> cjk_run;
    std::vector<uint32_t> cjk_tokens;  // hashed bigrams, appended after words

    auto flush_word = [&]() {
        if (word.empty()) return;
        if (!use_stopwords || stopwords().count(word) == 0) {
            out->push_back(fnv1a32(word.data(), word.size()) & mask);
        }
        word.clear();
    };

    auto encode_utf8 = [](uint32_t cp, char* buf) -> int {
        if (cp < 0x80) { buf[0] = static_cast<char>(cp); return 1; }
        if (cp < 0x800) {
            buf[0] = static_cast<char>(0xC0 | (cp >> 6));
            buf[1] = static_cast<char>(0x80 | (cp & 0x3F));
            return 2;
        }
        if (cp < 0x10000) {
            buf[0] = static_cast<char>(0xE0 | (cp >> 12));
            buf[1] = static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
            buf[2] = static_cast<char>(0x80 | (cp & 0x3F));
            return 3;
        }
        buf[0] = static_cast<char>(0xF0 | (cp >> 18));
        buf[1] = static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
        buf[2] = static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
        buf[3] = static_cast<char>(0x80 | (cp & 0x3F));
        return 4;
    };

    auto flush_cjk_run = [&]() {
        const size_t n = cjk_run.size();
        if (n == 0) return;
        char buf[8];
        if (n == 1) {
            int b = encode_utf8(cjk_run[0], buf);
            cjk_tokens.push_back(fnv1a32(buf, b) & mask);
        } else {
            for (size_t i = 0; i + 1 < n; ++i) {
                int b1 = encode_utf8(cjk_run[i], buf);
                int b2 = encode_utf8(cjk_run[i + 1], buf + b1);
                cjk_tokens.push_back(fnv1a32(buf, b1 + b2) & mask);
            }
        }
        cjk_run.clear();
    };

    size_t i = 0;
    while (i < len) {
        const char c = text[i];
        if (static_cast<uint8_t>(c) < 0x80) {
            const char lc = ascii_lower(c);
            if (is_word_char(lc)) {
                flush_cjk_run();
                word.push_back(lc);
            } else {
                flush_word();
                flush_cjk_run();
            }
            ++i;
        } else {
            uint32_t cp;
            const int consumed = utf8_decode(text + i, len - i, &cp);
            flush_word();
            if (is_cjk(cp)) {
                cjk_run.push_back(cp);
            } else {
                flush_cjk_run();
            }
            i += consumed;
        }
    }
    flush_word();
    flush_cjk_run();
    out->insert(out->end(), cjk_tokens.begin(), cjk_tokens.end());
    return static_cast<int64_t>(out->size());
}

}  // namespace

extern "C" {

// Build doc-term tables for a batch of documents.
//   texts: concatenated UTF-8 bytes; offsets[n_docs+1] delimit documents.
//   terms_out [n_docs, slots] int32 (pad = vocab_size)
//   tfs_out   [n_docs, slots] float32
//   lens_out  [n_docs] float32 (total token count)
// Returns 0 on success.
int analyze_docs(const char* texts, const int64_t* offsets, int n_docs,
                 uint32_t vocab_size, int slots, int use_stopwords,
                 int32_t* terms_out, float* tfs_out, float* lens_out) {
    if ((vocab_size & (vocab_size - 1)) != 0) return 1;  // must be 2^n
    const uint32_t mask = vocab_size - 1;
    std::vector<uint32_t> tokens;
    std::vector<std::pair<uint32_t, int32_t>> counts_vec;
    std::unordered_map<uint32_t, int32_t> counts;
    std::unordered_map<uint32_t, int32_t> first_seen;

    for (int d = 0; d < n_docs; ++d) {
        tokens.clear();
        counts.clear();
        first_seen.clear();
        const char* start = texts + offsets[d];
        const size_t len = static_cast<size_t>(offsets[d + 1] - offsets[d]);
        const int64_t doc_len =
            analyze_one(start, len, mask, use_stopwords != 0, &tokens);
        lens_out[d] = static_cast<float>(doc_len);

        int32_t order = 0;
        for (uint32_t t : tokens) {
            auto it = counts.find(t);
            if (it == counts.end()) {
                counts.emplace(t, 1);
                first_seen.emplace(t, order++);
            } else {
                ++it->second;
            }
        }
        counts_vec.assign(counts.begin(), counts.end());
        // highest tf first; ties by first appearance (Counter.most_common)
        std::sort(counts_vec.begin(), counts_vec.end(),
                  [&](const auto& a, const auto& b) {
                      if (a.second != b.second) return a.second > b.second;
                      return first_seen[a.first] < first_seen[b.first];
                  });
        int32_t* trow = terms_out + static_cast<int64_t>(d) * slots;
        float* frow = tfs_out + static_cast<int64_t>(d) * slots;
        for (int s = 0; s < slots; ++s) {
            if (s < static_cast<int>(counts_vec.size())) {
                trow[s] = static_cast<int32_t>(counts_vec[s].first);
                frow[s] = static_cast<float>(counts_vec[s].second);
            } else {
                trow[s] = static_cast<int32_t>(vocab_size);
                frow[s] = 0.0f;
            }
        }
    }
    return 0;
}

// Hash a batch of query tokens (already split) — helper for query paths.
void hash_terms(const char* texts, const int64_t* offsets, int n_terms,
                uint32_t vocab_size, uint32_t* out) {
    const uint32_t mask = vocab_size - 1;
    for (int i = 0; i < n_terms; ++i) {
        out[i] = fnv1a32(texts + offsets[i],
                         static_cast<size_t>(offsets[i + 1] - offsets[i])) & mask;
    }
}

}  // extern "C"
