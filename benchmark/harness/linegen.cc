// Formats one switch's flow-stats reply as monitor lines. Conversation i
// gives two lines, forward then reverse:
//   data\t<time>\t<mid row 2i>\t<cum[i][0]>\t<cum[i][1]>\n
//   data\t<time>\t<mid row 2i+1>\t<cum[i][2]>\t<cum[i][3]>\n
// ``mid`` holds 2n rows of ``mid_len`` bytes each (datapath, ports and
// MACs, each field followed by a tab); ``head`` is "data\t<time>\t";
// ``cum`` is n rows of four counters. ``out`` must hold
// 2n * (head_len + mid_len + 42) bytes. Returns the bytes written.
#include <cstddef>
#include <cstdint>
#include <cstring>

static inline char* put_u64(char* p, uint64_t v) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

static inline char* put_line(char* p, const char* head, size_t head_len,
                             const char* mid, size_t mid_len, int64_t a,
                             int64_t b) {
  std::memcpy(p, head, head_len);
  p += head_len;
  std::memcpy(p, mid, mid_len);
  p += mid_len;
  p = put_u64(p, static_cast<uint64_t>(a));
  *p++ = '\t';
  p = put_u64(p, static_cast<uint64_t>(b));
  *p++ = '\n';
  return p;
}

extern "C" size_t tcb_format_lines(char* out, const char* head, size_t head_len,
                                   const char* mid, size_t mid_len,
                                   const int64_t* cum, size_t n) {
  char* p = out;
  for (size_t i = 0; i < n; ++i) {
    const int64_t* c = cum + 4 * i;
    p = put_line(p, head, head_len, mid + 2 * i * mid_len, mid_len, c[0], c[1]);
    p = put_line(p, head, head_len, mid + (2 * i + 1) * mid_len, mid_len,
                 c[2], c[3]);
  }
  return static_cast<size_t>(p - out);
}
