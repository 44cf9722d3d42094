// Native data plane for the rayfed_tpu wire transport.
//
// The reference gets its native transport from third-party wheels (gRPC
// C-core + Ray's C++ core, SURVEY §2.9); this framework's equivalent is
// first-party: the byte-level hot path of the DCN push transport lives
// here — checksums, frame assembly, and large scatter-gather copies —
// callable from Python via ctypes with the GIL released, so the asyncio
// loop and codec threads never serialize on big memcpys.
//
// Build: g++ -O3 -march=native -shared -fPIC wirecodec.cc -o libwirecodec.so
// (see build.py; pure-Python fallbacks exist for every entry point).

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32-C (Castagnoli), slicing-by-8.  Table generated at first use.
// ---------------------------------------------------------------------------

static uint32_t crc_table[8][256];

static bool crc_init() {
  const uint32_t poly = 0x82f63b78u;  // reflected CRC32-C polynomial
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    crc_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = crc_table[0][i];
    for (int s = 1; s < 8; s++) {
      crc = (crc >> 8) ^ crc_table[0][crc & 0xff];
      crc_table[s][i] = crc;
    }
  }
  return true;
}

// Built at dlopen — see shift_init_done for why not lazily.
static const bool crc_init_done = crc_init();

#if defined(__SSE4_2__)
#include <nmmintrin.h>

// --- GF(2) crc-shift operator: advance a raw CRC register over N zero
// bytes, used to combine independent streams (zlib crc32_combine
// technique).  op is a 32x32 bit-matrix as 32 column words.
static inline uint32_t gf2_times(const uint32_t* mat, uint32_t vec) {
  uint32_t sum = 0;
  while (vec) {
    if (vec & 1) sum ^= *mat;
    vec >>= 1;
    mat++;
  }
  return sum;
}

static void gf2_square(uint32_t* dst, const uint32_t* mat) {
  for (int i = 0; i < 32; i++) dst[i] = gf2_times(mat, mat[i]);
}

// Build the operator matrix for shifting a (reflected) CRC32-C register
// by len_bytes of zeros: matrix exponentiation by squaring of the
// one-zero-bit operator.
static void crc_shift_op(uint32_t* out, uint64_t len_bytes) {
  uint32_t op[32], sq[32], t[32];
  op[0] = 0x82f63b78u;  // reflected polynomial: effect of one zero bit
  uint32_t row = 1;
  for (int i = 1; i < 32; i++) {
    op[i] = row;
    row <<= 1;
  }
  for (int i = 0; i < 32; i++) out[i] = 1u << i;  // identity
  uint64_t n = len_bytes * 8;                     // zero BITS to shift by
  while (n) {
    if (n & 1) {
      for (int i = 0; i < 32; i++) t[i] = gf2_times(op, out[i]);
      std::memcpy(out, t, sizeof t);
    }
    n >>= 1;
    if (!n) break;
    gf2_square(sq, op);
    std::memcpy(op, sq, sizeof sq);
  }
}

// 6-way interleaved kernel: this host's crc32q sustains ~5 GB/s on one
// chain (3-cycle latency) but ~14 GB/s with 6 independent streams.
// Streams are combined with precomputed shift operators, applied via
// 4x256 byte-lookup tables (built once).
static const uint64_t kLane = 8192;  // bytes per lane
static const int kNL = 6;            // lanes
static uint32_t shift_tab[kNL - 1][4][256];  // [s]: shift by (s+1)*kLane

static bool shift_init() {
  uint32_t mat[32];
  for (int s = 0; s < kNL - 1; s++) {
    crc_shift_op(mat, (uint64_t)(s + 1) * kLane);
    for (int b = 0; b < 4; b++)
      for (int v = 0; v < 256; v++)
        shift_tab[s][b][v] = gf2_times(mat, (uint32_t)v << (8 * b));
  }
  return true;
}

// Built at dlopen (single-threaded): rf_crc32c runs with the GIL
// released from many executor threads, and a lazy flag-guarded init
// would be an unsynchronized data race.
static const bool shift_init_done = shift_init();

static inline uint32_t shift_apply(const uint32_t tab[4][256], uint32_t crc) {
  return tab[0][crc & 0xff] ^ tab[1][(crc >> 8) & 0xff] ^
         tab[2][(crc >> 16) & 0xff] ^ tab[3][(crc >> 24) & 0xff];
}

uint32_t rf_crc32c(uint32_t seed, const uint8_t* data, uint64_t len) {
  uint32_t crc = ~seed;
  while (len && (reinterpret_cast<uintptr_t>(data) & 7)) {
    crc = _mm_crc32_u8(crc, *data++);
    len--;
  }
  if (len >= kNL * kLane) {
    (void)shift_init_done;
    while (len >= kNL * kLane) {
      const uint64_t* p0 = reinterpret_cast<const uint64_t*>(data);
      const uint64_t* p1 = reinterpret_cast<const uint64_t*>(data + kLane);
      const uint64_t* p2 = reinterpret_cast<const uint64_t*>(data + 2 * kLane);
      const uint64_t* p3 = reinterpret_cast<const uint64_t*>(data + 3 * kLane);
      const uint64_t* p4 = reinterpret_cast<const uint64_t*>(data + 4 * kLane);
      const uint64_t* p5 = reinterpret_cast<const uint64_t*>(data + 5 * kLane);
      uint64_t c0 = crc, c1 = 0, c2 = 0, c3 = 0, c4 = 0, c5 = 0;
      for (uint64_t i = 0; i < kLane / 8; i++) {
        c0 = _mm_crc32_u64(c0, p0[i]);
        c1 = _mm_crc32_u64(c1, p1[i]);
        c2 = _mm_crc32_u64(c2, p2[i]);
        c3 = _mm_crc32_u64(c3, p3[i]);
        c4 = _mm_crc32_u64(c4, p4[i]);
        c5 = _mm_crc32_u64(c5, p5[i]);
      }
      crc = shift_apply(shift_tab[4], (uint32_t)c0) ^
            shift_apply(shift_tab[3], (uint32_t)c1) ^
            shift_apply(shift_tab[2], (uint32_t)c2) ^
            shift_apply(shift_tab[1], (uint32_t)c3) ^
            shift_apply(shift_tab[0], (uint32_t)c4) ^ (uint32_t)c5;
      data += kNL * kLane;
      len -= kNL * kLane;
    }
  }
  uint64_t crc64 = crc;
  while (len >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data, 8);
    crc64 = _mm_crc32_u64(crc64, chunk);
    data += 8;
    len -= 8;
  }
  crc = static_cast<uint32_t>(crc64);
  while (len--) crc = _mm_crc32_u8(crc, *data++);
  return ~crc;
}
#else
uint32_t rf_crc32c(uint32_t seed, const uint8_t* data, uint64_t len) {
  (void)crc_init_done;
  uint32_t crc = ~seed;
  // Align to 8 bytes.
  while (len && (reinterpret_cast<uintptr_t>(data) & 7)) {
    crc = (crc >> 8) ^ crc_table[0][(crc ^ *data++) & 0xff];
    len--;
  }
  while (len >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data, 8);
    chunk ^= crc;  // little-endian assumption (x86-64 / aarch64)
    crc = crc_table[7][chunk & 0xff] ^ crc_table[6][(chunk >> 8) & 0xff] ^
          crc_table[5][(chunk >> 16) & 0xff] ^
          crc_table[4][(chunk >> 24) & 0xff] ^
          crc_table[3][(chunk >> 32) & 0xff] ^
          crc_table[2][(chunk >> 40) & 0xff] ^
          crc_table[1][(chunk >> 48) & 0xff] ^
          crc_table[0][(chunk >> 56) & 0xff];
    data += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ crc_table[0][(crc ^ *data++) & 0xff];
  return ~crc;
}
#endif  // __SSE4_2__

// ---------------------------------------------------------------------------
// Scatter-gather copy: assemble N source buffers into one destination.
// Returns total bytes copied.  Called with the GIL released.
// ---------------------------------------------------------------------------

uint64_t rf_gather_copy(uint8_t* dst, const uint8_t** srcs,
                        const uint64_t* lens, uint64_t n) {
  uint64_t off = 0;
  for (uint64_t i = 0; i < n; i++) {
    std::memcpy(dst + off, srcs[i], lens[i]);
    off += lens[i];
  }
  return off;
}

// Gather + checksum in one pass over the sources (saves a full re-read of
// the assembled buffer when both are needed).
uint64_t rf_gather_copy_crc(uint8_t* dst, const uint8_t** srcs,
                            const uint64_t* lens, uint64_t n,
                            uint32_t* crc_out) {
  uint64_t off = 0;
  uint32_t crc = 0;
  for (uint64_t i = 0; i < n; i++) {
    std::memcpy(dst + off, srcs[i], lens[i]);
    crc = rf_crc32c(crc, srcs[i], lens[i]);
    off += lens[i];
  }
  *crc_out = crc;
  return off;
}

// ---------------------------------------------------------------------------
// Vectored socket write: drain N buffers to a (possibly non-blocking) fd
// with writev, handling partial writes, EINTR, and EAGAIN (poll for
// writability).  Called with the GIL released, so the asyncio loop and
// codec threads keep running while the kernel drains multi-MB payloads.
// Returns total bytes written, or -errno on failure (-ETIMEDOUT when the
// fd stays unwritable for timeout_ms).
// ---------------------------------------------------------------------------

#include <sys/uio.h>
#include <poll.h>
#include <errno.h>

int64_t rf_writev_full(int fd, const uint8_t** bufs, const uint64_t* lens,
                       uint64_t n, int timeout_ms) {
  uint64_t i = 0;   // current buffer
  uint64_t off = 0; // offset into current buffer
  int64_t total = 0;
  while (i < n) {
    struct iovec iov[64];
    int cnt = 0;
    uint64_t j = i, o = off;
    while (j < n && cnt < 64) {
      if (lens[j] - o == 0) { j++; o = 0; continue; }
      iov[cnt].iov_base = const_cast<uint8_t*>(bufs[j]) + o;
      iov[cnt].iov_len = lens[j] - o;
      cnt++; j++; o = 0;
    }
    if (cnt == 0) break;  // only empty buffers remain
    ssize_t w = writev(fd, iov, cnt);
    if (w < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        struct pollfd p;
        p.fd = fd; p.events = POLLOUT; p.revents = 0;
        int pr = poll(&p, 1, timeout_ms);
        if (pr == 0) return -ETIMEDOUT;
        if (pr < 0 && errno != EINTR) return -static_cast<int64_t>(errno);
        continue;
      }
      return -static_cast<int64_t>(errno);
    }
    total += w;
    uint64_t adv = static_cast<uint64_t>(w);
    while (adv > 0) {
      uint64_t rem = lens[i] - off;
      if (adv >= rem) { adv -= rem; i++; off = 0; }
      else { off += adv; adv = 0; }
    }
    while (i < n && lens[i] == 0) i++;
  }
  return total;
}

}  // extern "C"
