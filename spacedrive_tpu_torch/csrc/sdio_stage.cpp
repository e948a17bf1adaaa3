// sdio_stage: the port's native staging plane, plain C interface.
//
// The staging half of the JAX package's native/sdio.cpp, as the port's own
// copy: batched reads of (path, declared size) pairs into dense rows, with
// no Python in the per-file loop. Three entry points:
//   sd_stage_large  sampled 57,344-byte payload rows of large files;
//   sd_stage_small  whole-file rows of up to `cap` (+1 grew byte) bytes;
//   sd_stage_batch  the identify main path: one call writes each row of a
//                   caller-owned page straight in the BLAKE3 kernel's
//                   message layout, le64(declared size) || payload || zeros,
//                   at stride C * 1024 (C = 57 large, 101 small).
// The sampling follows the reference's CAS IDs (core/src/object/cas.rs:
// header, four samples at offsets from the declared size, footer from the
// real end). Every row gets a status, so the caller degrades file by file.
//
// The caller's page is pinned host memory when it feeds an H100, so the
// host->device copy that follows is asynchronous; nothing here knows of
// CUDA. Built by spacedrive_tpu_torch/ops/_build.py with g++ at first use.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

// CAS sampling layout (core/src/object/cas.rs:10-15,23-62 semantics).
constexpr uint64_t SAMPLE_COUNT = 4;
constexpr uint64_t SAMPLE_SIZE = 1024 * 10;
constexpr uint64_t HEADER_OR_FOOTER_SIZE = 1024 * 8;
constexpr uint64_t MINIMUM_FILE_SIZE = 1024 * 100;
// Whole-file rows cap at the small-class edge.
constexpr uint64_t SMALL_WHOLE_CAP = MINIMUM_FILE_SIZE;
constexpr uint64_t LARGE_PAYLOAD =
    2 * HEADER_OR_FOOTER_SIZE + SAMPLE_COUNT * SAMPLE_SIZE;  // 57344

// Status codes shared with spacedrive_tpu_torch/native.py.
enum Status : int32_t {
  OK = 0,
  ERR_OPEN = -1,
  ERR_SHORT_READ = -2,
  ERR_GREW = -3,   // small file larger than its declared class
  ERR_EMPTY = -4,  // empty file: no CAS ID (mod.rs:86)
  ERR_IO = -5,
};

static void le64(uint64_t v, uint8_t out[8]) {
  for (int i = 0; i < 8; i++) out[i] = (uint8_t)(v >> (8 * i));
}

static bool pread_full(int fd, uint8_t* dst, size_t len, uint64_t off) {
  size_t done = 0;
  while (done < len) {
    ssize_t r = pread(fd, dst + done, len - done, (off_t)(off + done));
    if (r <= 0) return false;
    done += (size_t)r;
  }
  return true;
}

// Sampled read for a large (> 100 KiB) file into a 57,344-byte row.
// Header/sample offsets come from the declared size; the footer reads
// relative to the file's real end (SeekFrom::End(-8192) in cas.rs:57).
static int32_t read_sampled(int fd, uint64_t size, uint8_t* out) {
  uint64_t jump = (size - 2 * HEADER_OR_FOOTER_SIZE) / SAMPLE_COUNT;
  uint8_t* pos = out;
  if (!pread_full(fd, pos, HEADER_OR_FOOTER_SIZE, 0)) return ERR_SHORT_READ;
  pos += HEADER_OR_FOOTER_SIZE;
  for (uint64_t k = 0; k < SAMPLE_COUNT; k++) {
    if (!pread_full(fd, pos, SAMPLE_SIZE, HEADER_OR_FOOTER_SIZE + k * jump))
      return ERR_SHORT_READ;
    pos += SAMPLE_SIZE;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < HEADER_OR_FOOTER_SIZE)
    return ERR_SHORT_READ;
  if (!pread_full(fd, pos, HEADER_OR_FOOTER_SIZE,
                  (uint64_t)st.st_size - HEADER_OR_FOOTER_SIZE))
    return ERR_SHORT_READ;
  return OK;
}

// Whole-file read for a small (<= cap) file; flags files that grew.
static int32_t read_small(int fd, uint64_t cap, uint8_t* out,
                          int32_t* out_len) {
  size_t done = 0;
  for (;;) {
    ssize_t r = pread(fd, out + done, cap + 1 - done, (off_t)done);
    if (r < 0) return ERR_IO;
    if (r == 0) break;
    done += (size_t)r;
    if (done > cap) return ERR_GREW;
  }
  *out_len = (int32_t)done;
  return OK;
}

// Sampled read for a large file via one shared read-only mapping: six
// region memcpys out of the page cache instead of six preads. Offsets come
// from the DECLARED size (cas.rs:43 parity); every region is bounds-checked
// against the file's real length, so a file truncated between index and
// stage degrades to ERR_SHORT_READ exactly like the pread path. A mapping
// that fails degrades to read_sampled, which reads the same bytes. A
// truncate racing the memcpy itself can SIGBUS like any mapped reader;
// callers that cannot tolerate it stage through sd_stage_large instead.
static const uint64_t MMAP_THRESHOLD = 8ull << 20;  // 8 MiB

static int32_t read_sampled_mmap(int fd, uint64_t declared, uint8_t* out) {
  struct stat st;
  if (fstat(fd, &st) != 0) return ERR_IO;
  const uint64_t real = (uint64_t)st.st_size;
  if (real < HEADER_OR_FOOTER_SIZE) return ERR_SHORT_READ;
  // Below the threshold six preads beat a mapping: mmap + munmap cost two
  // syscalls plus a cross-thread TLB shootdown per file.
  if (real < MMAP_THRESHOLD) return read_sampled(fd, declared, out);
  void* m = mmap(nullptr, (size_t)real, PROT_READ, MAP_PRIVATE, fd, 0);
  if (m == MAP_FAILED) return read_sampled(fd, declared, out);
  const uint8_t* base = (const uint8_t*)m;
  const uint64_t jump = (declared - 2 * HEADER_OR_FOOTER_SIZE) / SAMPLE_COUNT;
  int32_t rc = OK;
  uint8_t* pos = out;
  std::memcpy(pos, base, HEADER_OR_FOOTER_SIZE);
  pos += HEADER_OR_FOOTER_SIZE;
  for (uint64_t k = 0; k < SAMPLE_COUNT; k++) {
    const uint64_t off = HEADER_OR_FOOTER_SIZE + k * jump;
    if (off + SAMPLE_SIZE > real) {
      rc = ERR_SHORT_READ;
      break;
    }
    std::memcpy(pos, base + off, SAMPLE_SIZE);
    pos += SAMPLE_SIZE;
  }
  if (rc == OK)
    std::memcpy(pos, base + (real - HEADER_OR_FOOTER_SIZE),
                HEADER_OR_FOOTER_SIZE);
  munmap(m, (size_t)real);
  return rc;
}

// Whole-file read for a small file, preadv straight into the packed row
// (the destination must have cap+1 bytes: the extra byte is the
// grew-past-class detector, landing in the row's zero padding).
static int32_t read_small_v(int fd, uint64_t cap, uint8_t* out,
                            int32_t* out_len) {
  size_t done = 0;
  for (;;) {
    struct iovec iov = {out + done, (size_t)(cap + 1 - done)};
    ssize_t r = preadv(fd, &iov, 1, (off_t)done);
    if (r < 0) {
      if (errno == EINTR) continue;
      return ERR_IO;
    }
    if (r == 0) break;
    done += (size_t)r;
    if (done > cap) return ERR_GREW;
  }
  *out_len = (int32_t)done;
  return OK;
}

// N items over an atomic cursor on n_threads workers (hardware_concurrency
// when n_threads <= 0, never more than N).
template <typename F>
static void parallel_for(int64_t n, int n_threads, F&& fn) {
  if (n <= 0) return;
  int hw = (int)std::thread::hardware_concurrency();
  if (hw <= 0) hw = 4;
  if (n_threads <= 0) n_threads = hw;
  if ((int64_t)n_threads > n) n_threads = (int)n;
  if (n_threads == 1) {
    for (int64_t i = 0; i < n; i++) fn(i);
    return;
  }
  std::atomic<int64_t> cursor{0};
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) {
    workers.emplace_back([&]() {
      for (;;) {
        int64_t i = cursor.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Stage a batch of large files: sampled 57,344-byte rows.
void sd_stage_large(int64_t n, const char** paths, const uint64_t* sizes,
                    uint8_t* out, int32_t* status, int n_threads) {
  parallel_for(n, n_threads, [&](int64_t i) {
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) {
      status[i] = ERR_OPEN;
      return;
    }
    status[i] = read_sampled(fd, sizes[i], out + i * LARGE_PAYLOAD);
    close(fd);
  });
}

// Stage a batch of small files: whole-file rows of up to `cap` bytes, at
// stride cap + 1.
void sd_stage_small(int64_t n, const char** paths, uint64_t cap, uint8_t* out,
                    int32_t* out_lens, int32_t* status, int n_threads) {
  parallel_for(n, n_threads, [&](int64_t i) {
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) {
      status[i] = ERR_OPEN;
      return;
    }
    status[i] = read_small(fd, cap, out + i * (cap + 1), &out_lens[i]);
    close(fd);
  });
}

// Packed batched staging: row i of the caller-owned [n, stride] page becomes
// le64(declared size) || payload || zeros with msg_lens[i] = 8 + payload
// bytes, build_cas_messages' exact layout. stride is the chunk grid of
// payload_cap (ceil((8 + payload_cap) / 1024) * 1024) and holds
// 8 + min(payload_cap, SMALL_WHOLE_CAP) + 1 bytes for the grew byte. Large
// rows (> MINIMUM_FILE_SIZE, when payload_cap holds the sampled payload)
// take the sampled payload through a shared mmap; small rows land whole
// through preadv. Any non-OK row is zeroed back to its 8-byte prefix, so a
// reused page never leaks a previous batch's bytes into a digest (the
// kernel hashes full 16-word blocks).
void sd_stage_batch(int64_t n, const char** paths, const uint64_t* sizes,
                    uint8_t* out, int64_t stride, uint64_t payload_cap,
                    int32_t* msg_lens, int32_t* status, int n_threads) {
  parallel_for(n, n_threads, [&](int64_t i) {
    uint8_t* row = out + i * stride;
    const uint64_t declared = sizes[i];
    le64(declared, row);
    uint64_t payload = 0;
    int32_t st;
    if (declared == 0) {
      st = ERR_EMPTY;  // no CAS ID for empty files (mod.rs:86)
    } else {
      int fd = open(paths[i], O_RDONLY);
      if (fd < 0) {
        st = ERR_OPEN;
      } else {
        if (declared > MINIMUM_FILE_SIZE && payload_cap >= LARGE_PAYLOAD) {
          st = read_sampled_mmap(fd, declared, row + 8);
          if (st == OK) payload = LARGE_PAYLOAD;
        } else {
          const uint64_t cap =
              payload_cap < SMALL_WHOLE_CAP ? payload_cap : SMALL_WHOLE_CAP;
          int32_t got = 0;
          st = read_small_v(fd, cap, row + 8, &got);
          if (st == OK) payload = (uint64_t)got;
        }
        close(fd);
      }
    }
    uint64_t keep = 8 + payload;
    if (st != OK) keep = 8;  // error/empty rows: prefix only, rest zeroed
    std::memset(row + keep, 0, (size_t)((uint64_t)stride - keep));
    msg_lens[i] = (int32_t)keep;
    status[i] = st;
  });
}

}  // extern "C"
