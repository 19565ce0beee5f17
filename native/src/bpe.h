// Byte-level BPE tokenizer (Qwen2/GPT-2 family) — native frontend.
//
// Same capability surface as the reference's io/tokenizer.{h,cpp} (vocab.json +
// merges.txt -> token ids) but a different engine: token strings are interned to
// integer symbols at load time, merges are a hash map over packed (left,right)
// symbol pairs carrying a precomputed merged symbol, and encoding runs a
// linked-list + min-heap merge loop — O(n log n) per chunk with zero string
// allocation in the hot path (the reference re-scans string pairs per merge,
// tokenizer.cpp:387-432).
//
// Two pre-tokenizer modes:
//   kQwen2        — the full HF Qwen2 regex semantics with Unicode \p{L}/\p{N}
//                   classes (correct for zh/ja/ko text; the reference's
//                   simplified ASCII regex, tokenizer.cpp:357-384, mishandles
//                   these by falling through to the punctuation class).
//   kReferenceAscii — byte-exact emulation of the reference's simplified
//                   pattern, for parity testing against its outputs.
#pragma once

#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

namespace qtts {

class QwenBpe {
 public:
  enum PreTokMode { kQwen2 = 0, kReferenceAscii = 1 };

  QwenBpe() = default;

  // Load vocab.json (token -> id) and merges.txt.  Returns false on I/O or
  // parse failure; check error() for details.  merges_path may be empty
  // (byte-level fallback encoding, mirroring the reference's degraded mode).
  bool load(const std::string& vocab_path, const std::string& merges_path,
            PreTokMode mode);

  std::vector<int32_t> encode(const std::string& text) const;
  std::string decode(const std::vector<int32_t>& ids) const;

  // Single-token lookups (reference io::token_to_string / string_to_token).
  std::string token_to_string(int32_t id) const;
  int32_t string_to_token(const std::string& token) const;

  bool loaded() const { return loaded_; }
  size_t vocab_size() const { return token_id_.size(); }
  size_t merges_size() const { return num_merges_; }
  const std::string& error() const { return error_; }

 private:
  struct MergeInfo {
    int32_t rank;
    int32_t merged_id;  // vocab id of the concatenated token (-1 if absent)
  };

  static uint64_t pack(int32_t a, int32_t b) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
           static_cast<uint32_t>(b);
  }

  bool parse_vocab_json(const std::string& path);
  bool parse_merges(const std::string& path);

  // Pre-tokenization: split text into chunks; each chunk is BPE'd independently.
  std::vector<std::pair<size_t, size_t>> pre_tokenize(
      const std::string& text) const;  // (offset, length) spans
  void bpe_chunk(const char* data, size_t len,
                 std::vector<int32_t>* out) const;

  PreTokMode mode_ = kQwen2;
  bool loaded_ = false;
  size_t num_merges_ = 0;
  std::string error_;

  std::unordered_map<std::string, int32_t> token_id_;
  std::vector<std::string> id_token_;          // dense id -> token string
  std::unordered_map<uint64_t, MergeInfo> merges_;
  int32_t byte_sym_[256];                      // byte -> vocab id of its proxy char
};

}  // namespace qtts
