// The port's host image I/O: PNG decode and encode, and a pool of threads
// that decodes a list of files ahead of its consumer.
//
// Plain C interface for ctypes (panodepth_torch/utils/nativeio.py), built
// with g++ at first use (kernels/_build.py) and linked against zlib's
// runtime library.  The decoder computes what io.read_png_py computes, bit
// for bit, and refuses what it refuses:
//
// * non-interlaced 8- and 16-bit gray, gray+alpha, RGB and RGBA, any mix
//   of the five row filters, any number of IDAT chunks;
// * every chunk's CRC is checked; the walk stops at IEND, and a file
//   without one (or with a chunk whose length runs past the end) is
//   truncated;
// * the IDAT stream must inflate to exactly height * (stride + 1) bytes.
//   A header whose size the compressed data cannot reach (deflate expands
//   at most 1032:1) is refused before anything is allocated.
//
// Pixels come back as integers, u8 or u16 in host byte order, shape
// (H, W * C); the caller normalizes.  Every refusal is a status and a
// message, never a crash: an allocation that fails is PD_NOMEM, in a
// worker thread too.

#include <zlib.h>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// One decode's result; mirrored by nativeio._Image.
struct pd_image {
  void* data;        // malloc'd pixels (or file bytes, kind PD_RAW); the
                     // caller owns it and frees it with pd_free
  size_t nbytes;
  int64_t height, width;
  int32_t channels, kind, status, err_no;
  char msg[256];
};

}  // extern "C"

namespace {

enum Status { PD_OK = 0, PD_OS = 1, PD_FORMAT = 2, PD_NOMEM = 3,
              PD_TAKEN = 4, PD_RANGE = 5 };
enum Kind { PD_U8 = 1, PD_U16 = 2, PD_RAW = 4 };

constexpr uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
// deflate's largest expansion: a 258-byte match in two bits
constexpr unsigned long long kInflateRatio = 1032;

struct Free { void operator()(void* p) const { free(p); } };
using Buf = std::unique_ptr<uint8_t, Free>;

Buf alloc(size_t n) {
  return Buf(static_cast<uint8_t*>(malloc(n ? n : 1)));
}

void reset(pd_image* im) {
  memset(im, 0, sizeof(*im));
}

int fail(pd_image* im, int status, const char* fmt, ...) {
  free(im->data);
  im->data = nullptr;
  im->nbytes = 0;
  im->status = status;
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(im->msg, sizeof(im->msg), fmt, ap);
  va_end(ap);
  return status;
}

int fail_os(pd_image* im, int err) {
  im->err_no = err;
  return fail(im, PD_OS, "%s", strerror(err));
}

uint32_t rd32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void wr32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}

uint32_t crc_of(const uint8_t* p, size_t n, uint32_t crc = 0) {
  while (n) {  // crc32 takes a 32-bit length
    uInt step = n > (1u << 30) ? (1u << 30) : static_cast<uInt>(n);
    crc = crc32(crc, p, step);
    p += step;
    n -= step;
  }
  return crc;
}

// A chunk type as Python's repr of its bytes, b'IDAT'.
std::string repr4(const uint8_t* k) {
  std::string s = "b'";
  for (int i = 0; i < 4; i++) {
    char esc[8];
    if (k[i] == '\\' || k[i] == '\'') { s += '\\'; s += char(k[i]); }
    else if (k[i] >= 32 && k[i] < 127) s += char(k[i]);
    else { snprintf(esc, sizeof(esc), "\\x%02x", k[i]); s += esc; }
  }
  return s + "'";
}

// The whole file into a malloc'd buffer; errno on failure.
int read_all(const char* path, Buf& out, size_t* n) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return errno;
  struct stat st;
  if (fstat(fd, &st) != 0) { int e = errno; close(fd); return e; }
  if (S_ISDIR(st.st_mode)) { close(fd); return EISDIR; }
  size_t cap = static_cast<size_t>(st.st_size) + 1, len = 0;
  Buf buf = alloc(cap);
  if (!buf) { close(fd); return ENOMEM; }
  for (;;) {
    if (len == cap) {  // the file grew since fstat
      cap = cap * 2 + 4096;
      void* p = realloc(buf.get(), cap);
      if (!p) { close(fd); return ENOMEM; }
      buf.release();
      buf.reset(static_cast<uint8_t*>(p));
    }
    ssize_t r = read(fd, buf.get() + len, cap - len);
    if (r < 0) {
      if (errno == EINTR) continue;
      int e = errno;
      close(fd);
      return e;
    }
    if (r == 0) break;
    len += static_cast<size_t>(r);
  }
  close(fd);
  out = std::move(buf);
  *n = len;
  return 0;
}

// ------------------------------------------------------------ unfiltering
// One row from the filtered bytes `src` into `dst`, `prior` the row above
// (zeros for the first); one loop per filter kind.

inline uint8_t paeth(int a, int b, int c) {
  int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  return static_cast<uint8_t>((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
}

bool unfilter_row(int kind, const uint8_t* __restrict src,
                  const uint8_t* __restrict prior, uint8_t* __restrict dst,
                  size_t stride, size_t bpp) {
  size_t head = bpp < stride ? bpp : stride;
  switch (kind) {
    case 0:
      memcpy(dst, src, stride);
      return true;
    case 1:
      for (size_t i = 0; i < head; i++) dst[i] = src[i];
      for (size_t i = bpp; i < stride; i++)
        dst[i] = static_cast<uint8_t>(src[i] + dst[i - bpp]);
      return true;
    case 2:
      for (size_t i = 0; i < stride; i++)
        dst[i] = static_cast<uint8_t>(src[i] + prior[i]);
      return true;
    case 3:
      for (size_t i = 0; i < head; i++)
        dst[i] = static_cast<uint8_t>(src[i] + (prior[i] >> 1));
      for (size_t i = bpp; i < stride; i++)
        dst[i] = static_cast<uint8_t>(
            src[i] + ((unsigned(dst[i - bpp]) + prior[i]) >> 1));
      return true;
    case 4:
      for (size_t i = 0; i < head; i++)
        dst[i] = static_cast<uint8_t>(src[i] + prior[i]);
      for (size_t i = bpp; i < stride; i++)
        dst[i] = static_cast<uint8_t>(
            src[i] + paeth(dst[i - bpp], prior[i], prior[i - bpp]));
      return true;
    default:
      return false;
  }
}

// ----------------------------------------------------------------- decode

int decode_png(const uint8_t* f, size_t n, pd_image* im) {
  if (n < 8 || memcmp(f, kSig, 8) != 0)
    return fail(im, PD_FORMAT, "not a PNG file");
  bool have_header = false, ended = false;
  uint32_t width = 0, height = 0;
  int depth = 0, colour = 0, interlace = 0;
  std::vector<std::pair<const uint8_t*, size_t>> idat;
  unsigned long long idat_bytes = 0;
  size_t pos = 8;
  while (pos + 8 <= n) {
    uint32_t len = rd32(f + pos);
    const uint8_t* kind = f + pos + 4;
    if (uint64_t(pos) + 12 + len > n) break;  // the length runs past the end
    const uint8_t* body = f + pos + 8;
    if (crc_of(body, len, crc_of(kind, 4)) != rd32(body + len))
      return fail(im, PD_FORMAT, "PNG chunk %s fails its CRC",
                  repr4(kind).c_str());
    if (memcmp(kind, "IHDR", 4) == 0) {
      if (len != 13)
        return fail(im, PD_FORMAT, "PNG IHDR chunk of %u bytes, not 13",
                    len);
      width = rd32(body);
      height = rd32(body + 4);
      depth = body[8];
      colour = body[9];
      interlace = body[12];
      have_header = true;
    } else if (memcmp(kind, "IDAT", 4) == 0) {
      idat.emplace_back(body, len);
      idat_bytes += len;
    } else if (memcmp(kind, "IEND", 4) == 0) {
      ended = true;
      break;
    }
    pos += 12 + size_t(len);
  }
  if (!ended) return fail(im, PD_FORMAT, "truncated PNG (no IEND)");
  if (!have_header) return fail(im, PD_FORMAT, "PNG without IHDR");
  int channels = colour == 0 ? 1 : colour == 2 ? 3 : colour == 4 ? 2 :
                 colour == 6 ? 4 : 0;
  if (!channels || (depth != 8 && depth != 16) || interlace)
    return fail(im, PD_FORMAT,
                "unsupported PNG (bit depth %d, colour type %d, interlace "
                "%d); this reader takes non-interlaced 8/16-bit gray, "
                "gray+alpha, RGB and RGBA", depth, colour, interlace);
  const size_t bpp = size_t(channels) * (depth / 8);
  const unsigned __int128 stride128 = (unsigned __int128)width * bpp;
  const unsigned __int128 need = (unsigned __int128)height * (stride128 + 1);
  if (need > (unsigned __int128)kInflateRatio * (idat_bytes + 1))
    return fail(im, PD_FORMAT,
                "PNG image data (%llu bytes compressed) cannot hold the "
                "%ux%u image its header gives", idat_bytes, width, height);
  const size_t stride = static_cast<size_t>(stride128);
  const size_t expected = static_cast<size_t>(need);

  Buf joined;
  const uint8_t* stream = idat.empty() ? f : idat[0].first;
  if (idat.size() > 1) {
    joined = alloc(idat_bytes);
    if (!joined) return fail(im, PD_NOMEM, "out of memory");
    size_t at = 0;
    for (auto& c : idat) {
      memcpy(joined.get() + at, c.first, c.second);
      at += c.second;
    }
    stream = joined.get();
  }
  Buf raw = alloc(expected);
  if (!raw) return fail(im, PD_NOMEM, "out of memory");
  uLongf got = expected;
  int z = uncompress(raw.get(), &got, stream, idat_bytes);
  joined.reset();
  if (z == Z_MEM_ERROR) return fail(im, PD_NOMEM, "out of memory");
  if (z == Z_BUF_ERROR)
    return fail(im, PD_FORMAT, "PNG image data does not end within the %zu "
                "bytes expected", expected);
  if (z != Z_OK)
    return fail(im, PD_FORMAT, "corrupt PNG image data (zlib error %d)", z);
  if (got != expected)
    return fail(im, PD_FORMAT, "PNG image data has %llu bytes, expected %zu",
                static_cast<unsigned long long>(got), expected);

  Buf out = alloc(size_t(height) * stride);
  Buf zeros(static_cast<uint8_t*>(calloc(stride ? stride : 1, 1)));
  if (!out || !zeros) return fail(im, PD_NOMEM, "out of memory");
  const uint8_t* prior = zeros.get();
  for (size_t y = 0; y < height; y++) {
    const uint8_t* src = raw.get() + y * (stride + 1);
    uint8_t* dst = out.get() + y * stride;
    if (!unfilter_row(src[0], src + 1, prior, dst, stride, bpp))
      return fail(im, PD_FORMAT, "bad PNG row filter %d", src[0]);
    prior = dst;
  }
  raw.reset();
  if (depth == 16) {  // big-endian samples to host order
    uint16_t* p = reinterpret_cast<uint16_t*>(out.get());
    size_t count = size_t(height) * stride / 2;
    for (size_t i = 0; i < count; i++) p[i] = __builtin_bswap16(p[i]);
  }
  im->data = out.release();
  im->nbytes = size_t(height) * stride;
  im->height = height;
  im->width = width;
  im->channels = channels;
  im->kind = depth == 16 ? PD_U16 : PD_U8;
  im->status = PD_OK;
  return PD_OK;
}

// A prefetched file: a PNG by its signature; anything else is handed back
// as its bytes for the caller's other codecs (io.decode_image tells files
// apart by their first bytes, so a JPEG under a .png name loads as there).
int decode_file(const char* path, pd_image* im) {
  Buf file;
  size_t n = 0;
  int err = read_all(path, file, &n);
  if (err) return fail_os(im, err);
  if (!(n >= 8 && memcmp(file.get(), kSig, 8) == 0)) {
    im->data = file.release();
    im->nbytes = n;
    im->kind = PD_RAW;
    im->status = PD_OK;
    return PD_OK;
  }
  return decode_png(file.get(), n, im);
}

template <typename F>
int guarded(pd_image* im, F&& body) {
  try {
    return body();
  } catch (const std::bad_alloc&) {
    return fail(im, PD_NOMEM, "out of memory");
  } catch (const std::exception& e) {
    return fail(im, PD_FORMAT, "internal error: %s", e.what());
  }
}

// --------------------------------------------------------------- prefetch

struct Item {
  std::string path;
  pd_image im;
  bool done = false, taken = false;
};

struct Prefetcher {
  std::vector<Item> items;
  std::atomic<size_t> next{0};
  std::atomic<bool> stop{false};
  std::mutex m;
  std::condition_variable cv;
  std::vector<std::thread> workers;

  void run() {
    while (!stop.load()) {
      size_t i = next.fetch_add(1);
      if (i >= items.size()) return;
      Item& it = items[i];
      reset(&it.im);
      guarded(&it.im, [&] { return decode_file(it.path.c_str(), &it.im); });
      {
        std::lock_guard<std::mutex> lk(m);
        it.done = true;
      }
      cv.notify_all();
    }
  }

  void halt() {
    stop = true;
    for (auto& w : workers) w.join();
    workers.clear();
  }
};

}  // namespace

extern "C" {

void pd_free(void* p) { free(p); }

// zlib's version at run time and that of the header built against.
const char* pd_zlib_version(void) { return zlibVersion(); }
const char* pd_zlib_header(void) { return ZLIB_VERSION; }

// Decodes a PNG from `data` (n bytes), or from the file `path` when data
// is NULL.  0 on success; else the status, with out->msg (and
// out->err_no for PD_OS).
int pd_png_decode(const char* path, const uint8_t* data, size_t n,
                  pd_image* out) {
  reset(out);
  return guarded(out, [&] {
    if (data) return decode_png(data, n, out);
    Buf file;
    size_t len = 0;
    int err = read_all(path, file, &len);
    if (err) return fail_os(out, err);
    return decode_png(file.get(), len, out);
  });
}

// A u8 or u16 (host order) image of `channels` (1: gray, 3: RGB) samples a
// pixel as a PNG: every row Up-filtered, one IDAT deflated by zlib at
// `level`.  Written to `path` when it is not NULL, else handed back in
// out->data (kind PD_RAW).
int pd_png_encode(const void* pixels, int64_t height, int64_t width,
                  int channels, int depth, int level, const char* path,
                  pd_image* out) {
  reset(out);
  return guarded(out, [&] {
    if ((channels != 1 && channels != 3) || (depth != 8 && depth != 16) ||
        height < 0 || width < 0 || height > 0x7fffffff ||
        width > 0x7fffffff)
      return fail(out, PD_FORMAT, "cannot encode a %lldx%lldx%d %d-bit "
                  "image", (long long)height, (long long)width, channels,
                  depth);
    const size_t stride = size_t(width) * channels * (depth / 8);
    const size_t rawlen = size_t(height) * (stride + 1);
    Buf raw = alloc(rawlen), cur = alloc(stride), prev(
        static_cast<uint8_t*>(calloc(stride ? stride : 1, 1)));
    if (!raw || !cur || !prev) return fail(out, PD_NOMEM, "out of memory");
    const uint8_t* src = static_cast<const uint8_t*>(pixels);
    for (size_t y = 0; y < size_t(height); y++) {
      uint8_t* c = cur.get();
      const uint8_t* row = src + y * stride;
      if (depth == 16) {  // big-endian samples
        const uint16_t* s = reinterpret_cast<const uint16_t*>(row);
        uint16_t* d = reinterpret_cast<uint16_t*>(c);
        for (size_t i = 0; i < stride / 2; i++) d[i] = __builtin_bswap16(s[i]);
      } else {
        memcpy(c, row, stride);
      }
      uint8_t* dst = raw.get() + y * (stride + 1);
      const uint8_t* p = prev.get();
      dst[0] = 2;  // Up; the first row's prior is zero
      for (size_t i = 0; i < stride; i++)
        dst[1 + i] = static_cast<uint8_t>(c[i] - p[i]);
      std::swap(cur, prev);
    }
    cur.reset();
    prev.reset();
    uLongf zlen = compressBound(rawlen);
    const size_t head = 8 + 25 + 8;  // signature, IHDR, IDAT's length+type
    Buf png = alloc(head + zlen + 4 + 12);
    if (!png) return fail(out, PD_NOMEM, "out of memory");
    uint8_t* q = png.get();
    int z = compress2(q + head, &zlen, raw.get(), rawlen, level);
    raw.reset();
    if (z == Z_MEM_ERROR) return fail(out, PD_NOMEM, "out of memory");
    if (z != Z_OK)
      return fail(out, PD_FORMAT, "PNG encode: bad deflate level %d (zlib "
                  "error %d)", level, z);
    memcpy(q, kSig, 8);
    wr32(q + 8, 13);
    memcpy(q + 12, "IHDR", 4);
    wr32(q + 16, uint32_t(width));
    wr32(q + 20, uint32_t(height));
    q[24] = uint8_t(depth);
    q[25] = channels == 1 ? 0 : 2;
    q[26] = q[27] = q[28] = 0;
    wr32(q + 29, crc_of(q + 12, 17));
    wr32(q + 33, uint32_t(zlen));
    memcpy(q + 37, "IDAT", 4);
    wr32(q + head + zlen, crc_of(q + 37, 4 + zlen));
    uint8_t* e = q + head + zlen + 4;
    wr32(e, 0);
    memcpy(e + 4, "IEND", 4);
    wr32(e + 8, crc_of(e + 4, 4));
    const size_t total = head + zlen + 4 + 12;
    if (!path) {
      out->data = png.release();
      out->nbytes = total;
      out->kind = PD_RAW;
      out->status = PD_OK;
      return int(PD_OK);
    }
    int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0666);
    if (fd < 0) return fail_os(out, errno);
    size_t at = 0;
    while (at < total) {
      ssize_t w = write(fd, q + at, total - at);
      if (w < 0) {
        if (errno == EINTR) continue;
        int err = errno;
        close(fd);
        return fail_os(out, err);
      }
      at += size_t(w);
    }
    if (close(fd) != 0) return fail_os(out, errno);
    out->status = PD_OK;
    return int(PD_OK);
  });
}

// Starts `threads` workers decoding `paths` (PNGs; other files are handed
// back as bytes) in order of index.  NULL if a thread could not be
// started.
void* pd_prefetch_start(const char** paths, int n, int threads) {
  Prefetcher* pf = nullptr;
  try {
    pf = new Prefetcher();
    pf->items.resize(n > 0 ? n : 0);
    for (int i = 0; i < n; i++) {
      pf->items[i].path = paths[i];
      reset(&pf->items[i].im);
    }
    for (int t = 0; t < (threads > 0 ? threads : 1); t++)
      pf->workers.emplace_back([pf] { pf->run(); });
    return pf;
  } catch (...) {
    if (pf) {
      pf->halt();
      for (auto& it : pf->items) free(it.im.data);
      delete pf;
    }
    return nullptr;
  }
}

// Waits for item `index` and hands its result over (out->data is then the
// caller's).  A second take of an item is PD_TAKEN, an index out of range
// PD_RANGE.
int pd_prefetch_take(void* handle, int index, pd_image* out) {
  Prefetcher* pf = static_cast<Prefetcher*>(handle);
  reset(out);
  if (index < 0 || size_t(index) >= pf->items.size())
    return fail(out, PD_RANGE, "item %d of %zu", index, pf->items.size());
  Item& it = pf->items[index];
  std::unique_lock<std::mutex> lk(pf->m);
  pf->cv.wait(lk, [&] { return it.done; });
  if (it.taken)
    return fail(out, PD_TAKEN, "item %d was taken already", index);
  it.taken = true;
  *out = it.im;
  it.im.data = nullptr;
  return out->status;
}

// Stops the workers taking new items, joins them and frees every result
// not taken.
void pd_prefetch_free(void* handle) {
  Prefetcher* pf = static_cast<Prefetcher*>(handle);
  pf->halt();
  for (auto& it : pf->items) free(it.im.data);
  delete pf;
}

}  // extern "C"
