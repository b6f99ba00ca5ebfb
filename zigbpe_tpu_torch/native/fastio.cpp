// Native host runtime for zigbpe-tpu: fast corpus loading plus a
// reference-semantics host tokenizer engine (train / encode replay).
//
// The reference implements its entire runtime in native code (Zig); these
// are the C++ equivalents for the host-side paths of the TPU framework:
// the data loader (utils/read_file.zig:3-13 analogue) and a single-core
// tokenizer engine with the exact observable semantics of
// basic_tokenizer.zig (train :140-205, encode :71-88), used for host
// fallback and as an honest native CPU baseline.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- file I/O

// Read an entire file. Returns malloc'd buffer (caller frees via
// zbpe_free) and stores the size. Returns nullptr on error.
uint8_t* zbpe_read_file(const char* path, int64_t* size_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return nullptr;
  }
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(size ? size : 1));
  if (buf && size > 0 && std::fread(buf, 1, size, f) != static_cast<size_t>(size)) {
    std::free(buf);
    buf = nullptr;
  }
  std::fclose(f);
  if (buf) *size_out = size;
  return buf;
}

void zbpe_free(void* p) { std::free(p); }

// ------------------------------------------------------------- merge pass

// One leftmost-greedy merge pass (basic_tokenizer.zig:207-232 semantics):
// newly written tokens are not re-matched within the pass. In-place over
// an int32 token buffer; returns the new length.
static int64_t greedy_pass(int32_t* t, int64_t n, int32_t a, int32_t b,
                           int32_t new_tok) {
  int64_t i = 0, j = 0;
  while (i < n) {
    if (i + 1 < n && t[i] == a && t[i + 1] == b) {
      t[j++] = new_tok;
      i += 2;
    } else {
      t[j++] = t[i++];
    }
  }
  return j;
}

// ------------------------------------------------------------------ train

// Train BPE merges with exact reference semantics + the documented
// deterministic tie-break (largest (first,second) wins on count ties).
// merges_out must hold 3*(vocab_size-256) int32s. Returns the number of
// merges produced, or -1 on invalid arguments.
int64_t zbpe_train(const uint8_t* data, int64_t n, int32_t vocab_size,
                   int32_t* merges_out) {
  if (vocab_size < 256 || vocab_size > 65536) return -1;
  const int64_t V = vocab_size;
  std::vector<int32_t> toks(n);
  for (int64_t i = 0; i < n; ++i) toks[i] = data[i];
  int64_t len = n;

  const bool dense_ok = V * V <= (int64_t)1 << 26;  // <= 256 MB of u32
  std::vector<uint32_t> dense;
  if (dense_ok) dense.assign(V * V, 0);

  int64_t k = 0;
  for (int32_t new_tok = 256; new_tok < vocab_size; ++new_tok) {
    if (len < 2) break;  // reference early stop (basic_tokenizer.zig:188-191)
    int64_t best_pid = -1;
    uint64_t best_count = 0;
    if (dense_ok) {
      for (int64_t i = 0; i + 1 < len; ++i)
        dense[(int64_t)toks[i] * V + toks[i + 1]]++;
      for (int64_t pid = 0; pid < V * V; ++pid) {
        uint32_t c = dense[pid];
        if (c == 0) continue;
        if (c > best_count || (c == best_count && pid > best_pid)) {
          best_count = c;
          best_pid = pid;
        }
        dense[pid] = 0;  // reset for next round while we're in cache
      }
    } else {
      std::unordered_map<int64_t, uint64_t> counts;
      counts.reserve(1 << 16);
      for (int64_t i = 0; i + 1 < len; ++i)
        counts[(int64_t)toks[i] * V + toks[i + 1]]++;
      for (const auto& kv : counts) {
        if (kv.second > best_count ||
            (kv.second == best_count && kv.first > best_pid)) {
          best_count = kv.second;
          best_pid = kv.first;
        }
      }
    }
    if (best_pid < 0) break;
    int32_t a = (int32_t)(best_pid / V), b = (int32_t)(best_pid % V);
    merges_out[k * 3] = a;
    merges_out[k * 3 + 1] = b;
    merges_out[k * 3 + 2] = new_tok;
    ++k;
    len = greedy_pass(toks.data(), len, a, b, new_tok);
  }
  return k;
}

// -------------------------------------------------------- byte-pair counts

// Histogram of adjacent BYTE pairs (the byte-level initial token stream,
// basic_tokenizer.zig:155-170 + :234-278 semantics, overlaps included).
// out must hold 256*256 int32s. Feeds the device trainer's upper-bound
// table initialisation: raw-byte pairs only ever hit the low 256x256
// block of the V*V table, and the host computes this while the corpus is
// still in host memory — cheaper than a device scatter over the stream.
void zbpe_byte_pair_hist(const uint8_t* data, int64_t n, int32_t* out) {
  std::memset(out, 0, 256 * 256 * sizeof(int32_t));
  for (int64_t i = 0; i + 1 < n; ++i) out[(int32_t)data[i] * 256 + data[i + 1]]++;
}

// ----------------------------------------------------------------- encode

// Encode by replaying merges in training order (basic_tokenizer.zig:71-88).
// out must hold n int32s. Returns the encoded length.
int64_t zbpe_encode(const uint8_t* data, int64_t n, const int32_t* merges,
                    int64_t num_merges, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = data[i];
  int64_t len = n;
  for (int64_t m = 0; m < num_merges && len >= 2; ++m) {
    len = greedy_pass(out, len, merges[m * 3], merges[m * 3 + 1],
                      merges[m * 3 + 2]);
  }
  return len;
}

}  // extern "C"
