// Native request validator (C++17, C ABI for ctypes).
//
// The reference's validator is part of its native serving layer
// (crates/core/src/validator.rs); this is the C++ tier counterpart with
// the exact decision semantics of core/validator.py — same check ORDER,
// same token estimate (ceil(codepoints/4)), same "blank" notion
// (Python str.strip(): Unicode whitespace). Python keeps the error
// MESSAGE formatting (cold path); this file makes the byte-scanning and
// range checks native.
//
// Return codes (shared by all three endpoints):
//   0 ok; 1 empty prompt; 2 token limit exceeded (*out_tokens = count);
//   3 bad max_tokens; 4 bad temperature; 5 bad top_p; 6 missing field.
// val_embeddings additionally sets *out_index to the offending input.

#include <cstdint>

namespace {

struct ValLimits {
  int64_t max_context_tokens;
  int64_t max_output_tokens;
  double min_temperature;
  double max_temperature;
  double min_top_p;
  double max_top_p;
};

// Unicode codepoints Python's str.isspace() treats as whitespace.
bool is_space_cp(uint32_t cp) {
  switch (cp) {
    case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D:
    case 0x1C: case 0x1D: case 0x1E: case 0x1F:
    case 0x20: case 0x85: case 0xA0: case 0x1680:
    case 0x2028: case 0x2029: case 0x202F: case 0x205F: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

// Decode one UTF-8 codepoint at s[i]; advances i. Invalid bytes decode
// as themselves (one codepoint per byte) — matches how such strings
// would already have failed JSON parsing upstream; counting stays sane.
uint32_t next_cp(const uint8_t* s, int64_t n, int64_t& i) {
  uint8_t b = s[i];
  int extra = 0;
  uint32_t cp = b;
  if ((b & 0xE0) == 0xC0) { extra = 1; cp = b & 0x1F; }
  else if ((b & 0xF0) == 0xE0) { extra = 2; cp = b & 0x0F; }
  else if ((b & 0xF8) == 0xF0) { extra = 3; cp = b & 0x07; }
  if (i + extra >= n) extra = 0;
  for (int k = 1; k <= extra; ++k) {
    uint8_t c = s[i + k];
    if ((c & 0xC0) != 0x80) { extra = k - 1; break; }
    cp = (cp << 6) | (c & 0x3F);
  }
  i += extra + 1;
  return cp;
}

// (codepoints, all_whitespace) in one scan.
void scan(const uint8_t* s, int64_t n, int64_t* cps, bool* blank) {
  int64_t count = 0;
  bool all_ws = true;
  for (int64_t i = 0; i < n;) {
    uint32_t cp = next_cp(s, n, i);
    ++count;
    if (all_ws && !is_space_cp(cp)) all_ws = false;
  }
  *cps = count;
  *blank = all_ws;
}

int64_t token_estimate(int64_t codepoints) {
  return codepoints == 0 ? 0 : (codepoints + 3) / 4;  // validator.py ceil/4
}

int check_sampling(int64_t max_tokens, double temperature, double top_p,
                   const ValLimits* lim) {
  if (max_tokens < 0 || max_tokens > lim->max_output_tokens) return 3;
  if (!(lim->min_temperature <= temperature &&
        temperature <= lim->max_temperature))
    return 4;
  if (!(lim->min_top_p <= top_p && top_p <= lim->max_top_p)) return 5;
  return 0;
}

}  // namespace

extern "C" {

int64_t val_token_count(const uint8_t* s, int64_t nbytes) {
  int64_t cps; bool blank;
  scan(s, nbytes, &cps, &blank);
  return token_estimate(cps);
}

int val_generate(const uint8_t* prompt, int64_t nbytes, int64_t max_tokens,
                 double temperature, double top_p, const ValLimits* lim,
                 int64_t* out_tokens) {
  int64_t cps; bool blank;
  scan(prompt, nbytes, &cps, &blank);
  if (nbytes == 0 || blank) return 1;
  int64_t toks = token_estimate(cps);
  *out_tokens = toks;
  if (toks > lim->max_context_tokens) return 2;
  return check_sampling(max_tokens, temperature, top_p, lim);
}

int val_chat(const uint8_t* const* contents, const int64_t* nbytes, int n,
             int64_t max_tokens, double temperature, double top_p,
             const ValLimits* lim, int64_t* out_tokens) {
  if (n == 0) return 6;
  bool any_content = false;
  int64_t total = 0;
  for (int i = 0; i < n; ++i) {
    int64_t cps; bool blank;
    scan(contents[i], nbytes[i], &cps, &blank);
    if (nbytes[i] != 0 && !blank) any_content = true;
    total += token_estimate(cps);
  }
  if (!any_content) return 1;
  *out_tokens = total;
  if (total > lim->max_context_tokens) return 2;
  return check_sampling(max_tokens, temperature, top_p, lim);
}

int val_embeddings(const uint8_t* const* inputs, const int64_t* nbytes, int n,
                   const ValLimits* lim, int64_t* out_tokens,
                   int* out_index) {
  if (n == 0) return 6;
  for (int i = 0; i < n; ++i) {
    int64_t cps; bool blank;
    scan(inputs[i], nbytes[i], &cps, &blank);
    *out_index = i;
    if (nbytes[i] == 0 || blank) return 1;
    int64_t toks = token_estimate(cps);
    *out_tokens = toks;
    if (toks > lim->max_context_tokens) return 2;
  }
  return 0;
}

}  // extern "C"
